from .pipeline import SyntheticDataset, ByteDataset
