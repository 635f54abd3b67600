"""KILT (DPR passages) tools: ``convert_trec_to_provenance`` and
``convert_to_evaluation``."""
