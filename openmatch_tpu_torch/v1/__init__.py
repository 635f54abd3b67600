from .kernel_matcher import KernelMatcher, kernel_mus_sigmas  # noqa: F401
from .models import KNRM, TK, ConvKNRM, EDRM, BertRanker, BertMaxP  # noqa: F401
