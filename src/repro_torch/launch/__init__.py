"""Command-line entry points of the port (`serve`, `train`, `train_lm`,
`analytics`)."""
