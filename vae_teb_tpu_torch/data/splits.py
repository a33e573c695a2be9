"""Cross-validation split construction.

Port of `vae_teb_tpu.data.splits` (numpy only): stratified per-subgroup
outer K-fold with an inner train/validation split, in the structure
{fold_k: {train/val/test: {group: [items]}}}, from plain NumPy
permutations, so a seed gives the JAX package's folds.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np


def kfold_indices(n: int, n_splits: int, seed: int) -> List[np.ndarray]:
    """Shuffled K-fold test-index sets (sizes differ by at most one)."""
    order = np.random.default_rng(seed).permutation(n)
    return [np.sort(part) for part in np.array_split(order, n_splits)]


def create_cv_splits(data: Dict[str, Sequence[str]],
                     n_splits: int = 10,
                     val_ratio: float = 0.1,
                     random_state: int = 42
                     ) -> Dict[str, Dict[str, Dict[str, List[str]]]]:
    """Stratified-by-subgroup outer K-fold + inner train/val split.

    data: subgroup name -> list of items (file paths / GUIDs). Every fold
    keeps each subgroup's proportions: the test set is that group's k-th
    fold, validation is val_ratio of the remainder.
    """
    group_folds = {g: kfold_indices(len(items), n_splits, random_state)
                   for g, items in data.items()}
    rng = np.random.default_rng(random_state)

    folds: Dict[str, Dict] = {}
    for fold_idx in range(n_splits):
        fold = {"train": {}, "val": {}, "test": {}}
        for group, items in data.items():
            test_idx = set(group_folds[group][fold_idx].tolist())
            remaining = np.array([i for i in range(len(items))
                                  if i not in test_idx])
            perm = rng.permutation(len(remaining))
            n_val = max(1, int(round(val_ratio * len(remaining)))) \
                if len(remaining) > 1 else 0
            val_idx = remaining[perm[:n_val]]
            train_idx = remaining[perm[n_val:]]
            fold["test"][group] = [items[i] for i in sorted(test_idx)]
            fold["val"][group] = [items[i] for i in sorted(val_idx)]
            fold["train"][group] = [items[i] for i in sorted(train_idx)]
        folds[f"fold_{fold_idx + 1}"] = fold
    return folds


def guid_label_splits(guids: Sequence[str], labels: Sequence[int],
                      n_splits: int = 10, val_ratio: float = 0.1,
                      random_state: int = 42) -> Dict:
    """Convenience wrapper: stratify GUIDs by class label (the classifier
    fold workflow)."""
    byclass: Dict[str, List[str]] = {}
    for g, lab in zip(guids, labels):
        byclass.setdefault(f"class_{int(lab)}", []).append(g)
    return create_cv_splits(byclass, n_splits=n_splits, val_ratio=val_ratio,
                            random_state=random_state)
