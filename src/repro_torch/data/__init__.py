from repro_torch.data.pipeline import TokenStreamConfig, federated_token_batches, token_batches
from repro_torch.data.synthetic import PAPER_DATASETS, DatasetSpec, get_dataset, make_classification

__all__ = ["PAPER_DATASETS", "DatasetSpec", "get_dataset", "make_classification",
           "TokenStreamConfig", "token_batches", "federated_token_batches"]
