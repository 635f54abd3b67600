"""Host-side data feeding: the port's own copies of the jax-free modules of
``openmatch_tpu/data`` that retrieval and training need. Import the modules
themselves; this package imports nothing."""
