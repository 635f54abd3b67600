"""The research recipes (port of ``openmatch_tpu/research``): T5 query
generation and ContrastQG (``qg``), MLM pretraining (``mlm``), Meta-LTR
(``meta_ltr``) and ReInfoSelect (``reinfoselect``)."""

from .meta_ltr import meta_reweight_step  # noqa: F401
from .mlm import MLMModel, mask_tokens  # noqa: F401
from .reinfoselect import DataSelectionPolicy, reinfoselect_round  # noqa: F401
