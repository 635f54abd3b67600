"""Ranks and their collectives (``mesh``), tensor parallelism (``tp``) and
GradCache (``grad_cache``). Import the modules themselves; this package
imports nothing."""
