"""String (assembly) graph: build, clean, unitig, output."""
