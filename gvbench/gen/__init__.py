"""The benchmark's input generator: everything a run feeds the program,
made from ``--seed``."""
