"""The port's own configurations of the paper's tuning targets."""
