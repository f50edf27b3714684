"""The binarized HDF5 item store (counterpart of
diffsinger_tpu/data/indexed_datasets.py): its reader and its writer.

``{prefix}.data`` holds one HDF5 group per item, keyed by the item's index;
items come back as dicts of numpy arrays (Python scalars for 0-d ones). The
file is read and written by the port's own codec, ``data/hdf5.py``, in the
format that h5py and the JAX package read and write.
"""

from __future__ import annotations

import pathlib
from typing import Dict, Optional, Sequence

from diffsinger_tpu_torch.data import hdf5


class IndexedDataset:
    def __init__(self, path, prefix: str):
        self.path = pathlib.Path(path) / f"{prefix}.data"
        if not self.path.exists():
            raise FileNotFoundError(f"IndexedDataset not found: {self.path}")
        self.dset = None

    def _ensure_open(self):
        # opened in the process that reads, so each worker and rank has its own
        if self.dset is None:
            self.dset = hdf5.Reader(self.path)

    def __getitem__(self, i: int) -> Dict:
        self._ensure_open()
        if i < 0 or i >= len(self.dset):
            raise IndexError("index out of range")
        return {k: (v.item() if v.shape == () else v)
                for k, v in self.dset.read_group(str(i)).items()}

    def __len__(self) -> int:
        self._ensure_open()
        return len(self.dset)

    def close(self):
        if self.dset is not None:
            self.dset.close()
            self.dset = None


class IndexedDatasetBuilder:
    """Writes items, numbered from 0 in the order they come, as the groups of
    ``{path}/{prefix}.data``; only the attributes in ``allowed_attr`` (all
    when None) are kept, and None values are left out."""

    def __init__(self, path, prefix: str, allowed_attr: Optional[Sequence[str]] = None):
        self.path = pathlib.Path(path) / f"{prefix}.data"
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self.dset = hdf5.Writer(self.path)
        self.counter = 0
        self.allowed_attr = set(allowed_attr) if allowed_attr is not None else None

    def add_item(self, item: Dict) -> int:
        if self.allowed_attr is not None:
            item = {k: item[k] for k in self.allowed_attr if k in item}
        item_no = self.counter
        self.counter += 1
        self.dset.add_group(str(item_no), {k: v for k, v in item.items() if v is not None})
        return item_no

    def finalize(self):
        self.dset.close()
