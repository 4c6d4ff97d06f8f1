"""Index construction on a torch device: the suffix sort of a batch
(sa.py, K7) and the merge of a partial BWT into an index (merge.py, K6)."""
