"""MS MARCO train-data tools: ``build_train`` and ``build_hn``."""
