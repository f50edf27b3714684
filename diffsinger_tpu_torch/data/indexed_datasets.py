"""Reader of the binarized HDF5 item store
(counterpart of the reader in diffsinger_tpu/data/indexed_datasets.py).

``{prefix}.data`` holds one HDF5 group per item, keyed by the item's index;
items come back as dicts of numpy arrays. ``h5py`` is imported when a file is
opened, so the package imports on hosts without it. The writer comes with the
port's binarizers.
"""

from __future__ import annotations

import pathlib
from typing import Dict


class IndexedDataset:
    def __init__(self, path, prefix: str):
        self.path = pathlib.Path(path) / f"{prefix}.data"
        if not self.path.exists():
            raise FileNotFoundError(f"IndexedDataset not found: {self.path}")
        self.dset = None

    def _ensure_open(self):
        if self.dset is None:
            import h5py

            self.dset = h5py.File(self.path, "r")

    def __getitem__(self, i: int) -> Dict:
        import numpy as np

        self._ensure_open()
        if i < 0 or i >= len(self.dset):
            raise IndexError("index out of range")
        return {k: (v[()].item() if v.shape == () else np.asarray(v[()]))
                for k, v in self.dset[str(i)].items()}

    def __len__(self) -> int:
        self._ensure_open()
        return len(self.dset)

    def close(self):
        if self.dset is not None:
            self.dset.close()
            self.dset = None
