"""Learned-index simulators and the tuning environment (twin of
`repro/index`)."""
