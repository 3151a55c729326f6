from repro_torch.data.synthetic import PAPER_DATASETS, DatasetSpec, get_dataset, make_classification

__all__ = ["PAPER_DATASETS", "DatasetSpec", "get_dataset", "make_classification"]
