"""Haplotype-aware error correction (the ``ecovlp.cpp`` subsystem)."""
