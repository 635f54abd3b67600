"""Host-side data feeding: the port's own copies of the jax-free modules of
``openmatch_tpu/data`` that the retrieval path needs. Import the modules
themselves; this package imports nothing."""
