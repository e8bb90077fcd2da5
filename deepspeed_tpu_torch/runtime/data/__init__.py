from .indexed_dataset import (IndexedDataset, IndexedDatasetBuilder,
                              NativePrefetchLoader)

__all__ = ["IndexedDataset", "IndexedDatasetBuilder", "NativePrefetchLoader"]
