from .bert import BertConfig, BertEncoder  # noqa: F401
from .dr_model import DRModel  # noqa: F401
from .pooling import LinearHead, pool_hidden  # noqa: F401
