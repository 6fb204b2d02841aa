"""One driver a way of running the program (``train``), named by a
workload file's ``driver``."""
