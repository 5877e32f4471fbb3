"""The benchmark's yardstick: model FLOPs, roofline work and published
peaks, and the sorting of device kernels by kind. Frozen copies of the
program's arithmetic, so that a later change to the program cannot move the
measure it is held to."""
