"""Datasets: the synthetic tabular benchmark suite (paper Table III)."""

from .tabular import DATASETS, TabularDataset, load_dataset

__all__ = ["DATASETS", "TabularDataset", "load_dataset"]
