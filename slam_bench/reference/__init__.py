"""The plain references that decide ``correct``: straightforward PyTorch
of the same mathematics as the program, written from the published method
and the program's documented conventions, importing nothing of the
program.  They take the raw frames the benchmark hands to the program and
work out everything else again."""
