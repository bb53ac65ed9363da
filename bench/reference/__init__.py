"""The plain reference the benchmark holds every coded row against.

Plain Python integers for the generators and plain PyTorch for the products,
worked out again from a configuration file alone: nothing here imports the
program under test or takes anything the program made. Each generator
construction is a module of :mod:`bench.reference.generators`, found by the
name a configuration gives it.
"""
