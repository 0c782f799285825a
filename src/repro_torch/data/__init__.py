"""The bitmap-indexed data pipeline of the port (the twin of
``repro.data``)."""
from repro_torch.data.pipeline import (  # noqa: F401
    BitmapIndexedDataset, SyntheticCorpus, DataConfig,
)
