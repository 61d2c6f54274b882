"""Generation and post-processing of decoder outputs."""
