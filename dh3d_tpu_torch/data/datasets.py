"""Eval-time cloud loaders (copy of `dh3d_tpu/data/datasets.py:248-320`,
themselves `core/datasets.py:60-100,236-274`): plain Python iterators with a
seeded numpy RNG.  The optional host kNN takes `scipy.spatial.cKDTree`
instead of sklearn's ball tree; the two may order neighbours at exactly
equal distances differently.  The training samplers are not ported yet.
"""

from __future__ import annotations

import glob
import os
from typing import List, Optional

import numpy as np

from dh3d_tpu_torch.data.io import (
    get_fixednum_pcd,
    get_sets_dict,
    load_single_pcfile,
)


class LocalTestDataset:
    """Eval-time cloud loader with fixed-size normalisation and optional
    host kNN.  Yields [cloud [numpts, 3] f32, file name, ori_num
    (, knn_ind [numpts, knn_require] int32)]."""

    def __init__(self, basedir, numpts=2 * 8192, knn_require=8, dim=6,
                 seed=0):
        if not os.path.isdir(basedir):
            raise FileNotFoundError(f"no directory {basedir}")
        self.basedir = basedir
        self.files = sorted(glob.glob(os.path.join(basedir, "*.bin")))
        self.knn = knn_require
        self.numpts = numpts
        self.dim = dim
        self.rng = np.random.RandomState(seed)

    def __len__(self):
        return len(self.files)

    def __iter__(self):
        from scipy.spatial import cKDTree

        for pcfile in self.files:
            cloud = load_single_pcfile(pcfile, dim=self.dim)
            ori_num = cloud.shape[0]
            if ori_num != self.numpts:
                cloud, ori_num = get_fixednum_pcd(
                    cloud, self.numpts, randsample=False,
                    need_downsample=True, rng=self.rng,
                )
            else:
                choice = self.rng.choice(cloud.shape[0], self.numpts,
                                         replace=False)
                cloud = cloud[choice, :]
            ret = [cloud, os.path.basename(pcfile), ori_num]
            if self.knn > 0:
                _, knn_ind = cKDTree(cloud).query(cloud, k=self.knn)
                ret.append(np.asarray(knn_ind, np.int32)
                           .reshape(len(cloud), self.knn))
            yield ret


class GlobalTestDataset:
    """Sequence-ordered eval loader.  Yields [cloud [numpts, 3] f32, name]
    for every cloud of every sequence of the GT pickle `test_file`."""

    def __init__(self, basedir, test_file, numpts=4096 * 2,
                 eval_sequences: Optional[List[str]] = None, seed=0):
        if not os.path.isdir(basedir):
            raise FileNotFoundError(f"no directory {basedir}")
        self.basedir = basedir
        self.testdict = get_sets_dict(test_file)
        self.numpts = numpts
        self.sequences = sorted(
            eval_sequences if eval_sequences is not None
            else self.testdict.keys()
        )
        self.files = [
            pcd["query"] + ".bin"
            for seq in self.sequences
            for pcd in self.testdict[seq]
        ]
        self.rng = np.random.RandomState(seed)

    def __len__(self):
        return len(self.files)

    def __iter__(self):
        for name in self.files:
            pcd = load_single_pcfile(os.path.join(self.basedir, name))
            if pcd.shape[0] != self.numpts:
                pcd, _ = get_fixednum_pcd(
                    pcd, self.numpts, randsample=True,
                    need_downsample=False, sortby_dis=True, rng=self.rng,
                )
            yield [pcd, name]
