from .classic_extractor import ClassicExtractor, Corpus  # noqa: F401
from .coor_ascent import CoorAscent  # noqa: F401
from .ranksvm import RankSVM  # noqa: F401
from .features import (  # noqa: F401
    kfold_split,
    load_feature_file,
    save_feature_file,
    scores_to_trec,
)
