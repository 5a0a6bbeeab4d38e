"""PRNG keys, ZO estimation and the MU-SplitFed round."""
