"""Evaluation: batched embedding of index rows and the six-metric pan-organ
protocol (numpy, with the port's own linear estimators)."""
