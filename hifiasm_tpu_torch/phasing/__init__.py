"""Haplotype phasing solvers (max-cut spins, Hi-C integration)."""
