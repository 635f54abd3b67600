"""TREC run files, metrics and profiling: the port's own copies of the JAX
package's ``utils/trec.py`` and ``utils/metrics.py`` and its torch twin of
``utils/profiling.py``. Import the modules themselves; this package
imports nothing."""
