"""Readers of ropebwt3's on-disk formats, copied from ropebwt3_tpu/formats:
the decode side of fmd ("RLD\\3"), fmr ("RB\\2") and bre ("BRE\\1"), and the
ssa ("SSA\\1") reader and writer.  Every codec speaks runs: (symbols uint8,
lengths int64) of the run-length BWT."""
