from repro_torch.data.libsvm import (
    PAPER_DATASETS,
    LogRegDataset,
    make_synthetic_libsvm,
    parse_libsvm_file,
)
from repro_torch.data.synthetic_lm import SyntheticLMDataset

__all__ = ["PAPER_DATASETS", "LogRegDataset", "make_synthetic_libsvm",
           "parse_libsvm_file", "SyntheticLMDataset"]
