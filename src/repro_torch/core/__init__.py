"""PRNG keys, ZO estimation, the MU-SplitFed round, straggler schedules
and the synchronous engine."""
