"""NQ (DPR json) train-data tool: ``build_train``."""
