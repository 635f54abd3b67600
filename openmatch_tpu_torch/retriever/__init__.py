from .encoder import encode_dataset, load_embeddings, save_embeddings  # noqa: F401
from .retriever import Retriever  # noqa: F401
