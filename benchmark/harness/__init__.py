"""The benchmark's harness: finds a cell's configuration, traffic mix,
metric readers and limits by name, makes the inputs and weights from the
seed, drives the program, reads the profiler's trace and compares the
program's outputs with the plain reference."""
