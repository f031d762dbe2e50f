from repro_torch.data.pipeline import (  # noqa: F401
    ByteTokenizer, synthetic_corpus, TokenDataset)
