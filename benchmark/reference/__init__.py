"""The plain reference the benchmark holds the program against: float32
PyTorch with TF32 off, no kernels, no batching tricks. It imports torch and
numpy only (never the program, never JAX), takes the inputs and weights the
benchmark makes, and works out again everything the program derives from
them: the augmented views, the forwards, the losses, the gradients, the
update, the EMA and the centre, and the evaluation transform.

Every matrix product goes through a ``mm`` argument, ``torch.matmul`` by
default; :mod:`reference.lowp` gives the lower-precision product that the
control runs the same reference with."""
