"""The GTR checkpoint tool: ``convert_gtr_ckpt``."""
