"""The benchmark's plain reference: what a correct assembly of the
benchmark's own inputs must show, worked out with NumPy from the genome
that the inputs were sampled from.  Imports nothing of the program."""
