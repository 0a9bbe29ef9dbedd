"""Dataset registry: the counterpart of nero_tpu/dataset/train_dataset.py.

The step loop draws its batches inside the models (on the device), so
`DummyDataset` exists to honour the YAML keys `train_dataset_type: dummy` /
`val_set_list` and to size validation loops. No training path calls it,
here as in nero_tpu.
"""
from __future__ import annotations


class DummyDataset:
    """Yields step/validation indices; no payload."""

    def __init__(self, cfg: dict, is_train: bool):
        self.cfg = cfg
        self.is_train = is_train

    def __len__(self):
        if self.is_train:
            return 999999999
        from nero_tpu_torch.dataset.database import get_database_split, parse_database_name
        database = parse_database_name(self.cfg["database_name"])
        _, test_ids = get_database_split(database)
        return len(test_ids)

    def __getitem__(self, index):
        return {"index": index}

    def reset(self):
        pass


def dummy_collate_fn(data_list):
    return data_list[0]


name2dataset = {
    "dummy": DummyDataset,
}
