from .mips import Searcher, exact_search  # noqa: F401
