"""DINO pretraining: losses, LR schedule, train state and optimizer, and the
training step."""
