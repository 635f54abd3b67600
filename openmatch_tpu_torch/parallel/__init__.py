"""GradCache (``grad_cache``). Import the module itself; this package
imports nothing."""
