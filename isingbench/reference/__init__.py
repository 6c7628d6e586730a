"""The plain reference that decides a run's `correct`: torch only, nothing
of the measured program."""
