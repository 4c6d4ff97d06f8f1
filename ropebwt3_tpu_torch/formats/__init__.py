"""Readers and writers of ropebwt3's on-disk formats, copied from
ropebwt3_tpu/formats: fmd ("RLD\\3"), fmr ("RB\\2"), bre ("BRE\\1") and ssa
("SSA\\1").  Every BWT codec speaks runs: (symbols uint8, lengths int64) of
the run-length BWT."""
