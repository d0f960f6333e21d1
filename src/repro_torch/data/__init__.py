from .pipeline import SyntheticLM, MemmapCorpus, Prefetcher, make_source, \
    torch_batch

__all__ = ["SyntheticLM", "MemmapCorpus", "Prefetcher", "make_source",
           "torch_batch"]
