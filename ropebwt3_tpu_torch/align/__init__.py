"""The hapdiv aligner: its options, the native DP and the device engine."""
