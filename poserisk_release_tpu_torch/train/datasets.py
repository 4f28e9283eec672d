"""Dataset composition utilities (host-side, framework-agnostic indexables).

Own copy of the JAX package's train/datasets.py (pure numpy), the
equivalents of the reference's torch Dataset helpers:
  * MultipleDatasets (reference data/multiple_datasets.py:6-40) --
    uniform-db sampling with same-length virtualisation;
  * FeatureDataset windows (reference data/demo_dataset.py:77-107) --
    seq_len-sized index windows with edge replication for temporal models;
  * split_into_chunks (reference lib/utils/_img_utils.py:337-376) --
    per-video sliding windows (the reference version crashes on an undefined
    import; rebuilt working here).

These return plain indices / numpy data, consumable by any loader that feeds
the device.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


class MultipleDatasets:
    """Mix several indexable datasets; same-length mode samples the db
    uniformly per item (reference semantics, with an explicit rng for
    reproducibility instead of the global random module)."""

    def __init__(self, dbs: Sequence, make_same_len: bool = True, seed: int = 0):
        if not dbs:
            raise ValueError("need at least one dataset")
        self.dbs = list(dbs)
        self.db_num = len(self.dbs)
        self.max_db_data_num = max(len(db) for db in self.dbs)
        self.db_len_cumsum = np.cumsum([len(db) for db in self.dbs])
        self.make_same_len = make_same_len
        self._rng = np.random.RandomState(seed)

    def __len__(self) -> int:
        if self.make_same_len:
            return self.max_db_data_num * self.db_num
        return int(self.db_len_cumsum[-1])

    def __getitem__(self, index: int):
        if self.make_same_len:
            db_idx = int(self._rng.randint(0, self.db_num))
            db = self.dbs[db_idx]
            data_idx = index % self.max_db_data_num
            whole_repeats = len(db) * (self.max_db_data_num // len(db))
            if data_idx >= whole_repeats:
                data_idx = int(self._rng.randint(0, len(db)))
            else:
                data_idx = data_idx % len(db)
            return db[data_idx]
        db_idx = int(np.searchsorted(self.db_len_cumsum, index, side="right"))
        offset = 0 if db_idx == 0 else int(self.db_len_cumsum[db_idx - 1])
        return self.dbs[db_idx][index - offset]


def sequence_windows(num_items: int, seq_len: int = 16) -> List[Tuple[int, int]]:
    """FeatureDataset's window list: inclusive [start, end] index pairs with
    half-window edge replication (demo_dataset.py:89-93)."""
    windows = [[i, i + seq_len - 1] for i in range(num_items - seq_len + 1)]
    for i in range(1, seq_len // 2 + 1):
        windows.insert(0, [seq_len // 2 - i, seq_len // 2 - i])
    for i in range(1, seq_len // 2):
        windows.append([-(seq_len // 2) + i, -(seq_len // 2) + i])
    return [tuple(w) for w in windows]


def gather_window(features: np.ndarray, window: Tuple[int, int], seq_len: int) -> np.ndarray:
    """Materialise one window: a range slice, or a single frame replicated
    seq_len times for the edge windows (demo_dataset.py:98-102)."""
    start, end = window
    if start != end:
        return features[start : end + 1]
    return np.repeat(features[start][None], seq_len, axis=0)


def split_into_chunks(
    vid_names: np.ndarray, seqlen: int, stride: int,
    is_train: bool = True, match_vibe: bool = True,
) -> List[List[int]]:
    """Per-video [start, end] windows over a flat frame list tagged by video
    name: a working rebuild of the FULL _img_utils.py:337-376 semantics (the
    reference crashes on its undefined view_as_windows import; its intent --
    skimage's sliding windows -- is unambiguous).

    stride == seqlen: plain non-overlapping windows. stride != seqlen adds
    the reference's two extras: (a) match_vibe trims trailing windows so the
    last one ends where the last COMPLETE 16-step window ends (VIBE window
    alignment); (b) seqlen/2 dummy entries are inserted at the front and
    ceil(seqlen/2)-1 appended at the back -- copies of the first/last real
    window when is_train, else single-frame [d+j, d+j] edge markers --
    reproducing the reference's exact insert/append arithmetic. One
    divergence, forced by runnability: a video shorter than 16 frames (but
    >= seqlen) would make the reference's vibe_chunks[-1] raise IndexError;
    here the trim is skipped for such videos."""
    out: List[List[int]] = []
    _names, group = np.unique(vid_names, return_index=True)
    group = np.sort(group)
    indices = np.split(np.arange(vid_names.shape[0]), group[1:])
    for indexes in indices:
        if indexes.shape[0] < seqlen:
            continue
        start_finish = [
            [int(indexes[s]), int(indexes[s + seqlen - 1])]
            for s in range(0, indexes.shape[0] - seqlen + 1, stride)
        ]
        if stride != seqlen:
            if match_vibe and indexes.shape[0] >= 16:
                n16 = indexes.shape[0] // 16
                vibe_last_end = int(indexes[n16 * 16 - 1])
                for j in range(1, len(start_finish) + 1):
                    if start_finish[-j][-1] == vibe_last_end:
                        if j != 1:
                            start_finish = start_finish[: -j + 1]
                        break
            d = start_finish[0][0]
            for j in range(int(seqlen / 2)):
                dummy = start_finish[0] if is_train else [d + j, d + j]
                start_finish.insert(j, list(dummy))
            d = start_finish[-1][0]
            for j in range(int(seqlen / 2 + 0.5) - 1):
                dummy = (start_finish[-1] if is_train
                         else [d + int(seqlen / 2) + j + 1,
                               d + int(seqlen / 2) + j + 1])
                start_finish.append(list(dummy))
        out += start_finish
    return out


class BatchIterator:
    """Minimal batch iterator: yields stacked numpy batches from an
    indexable dataset (in place of a DataLoader; workers are unnecessary
    since the heavy work is on the device)."""

    def __init__(self, dataset, batch_size: int, drop_last: bool = False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.drop_last = drop_last

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else (n + self.batch_size - 1) // self.batch_size

    def __iter__(self):
        n = len(self.dataset)
        for start in range(0, n, self.batch_size):
            stop = min(start + self.batch_size, n)
            if self.drop_last and stop - start < self.batch_size:
                return
            yield np.stack([np.asarray(self.dataset[i]) for i in range(start, stop)])
