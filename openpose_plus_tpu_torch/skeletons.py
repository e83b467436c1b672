"""The body schemas the port decodes: OpenPose's 18-part COCO body (the
tables of `skeleton.py`, unchanged) and OpenPose's 25-part BODY_25 body
(COCO's parts, the mid hip and six foot points).

A `Skeleton` holds what the decoder needs of a schema: the parts (heatmap
channels 0 .. n_parts - 1, the background after them), the limbs as
(part_a, part_b) in the order the grouping takes them, the (x, y) PAF
channels of each limb, and `person_limbs`: the limbs before it may start a
person, the rest only join one. `find` gives the schema of a tensor's
counts (parts, limbs, heatmap or PAF channels), `for_maps` that of a
network's maps; neither has a default.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from openpose_plus_tpu_torch import skeleton


@dataclasses.dataclass(frozen=True)
class Skeleton:
    name: str
    parts: tuple[str, ...]
    limbs: tuple[tuple[int, int], ...]
    paf_channels: tuple[tuple[int, int], ...]
    person_limbs: int

    @property
    def n_parts(self) -> int:
        return len(self.parts)

    @property
    def n_limbs(self) -> int:
        return len(self.limbs)

    @property
    def n_heatmaps(self) -> int:
        """Parts and the background channel."""
        return self.n_parts + 1

    @property
    def n_pafs(self) -> int:
        return 2 * self.n_limbs

    def pairs_array(self) -> np.ndarray:
        """(n_limbs, 2) int32 limb endpoint part indices."""
        return np.asarray(self.limbs, dtype=np.int32)

    def paf_channels_array(self) -> np.ndarray:
        """(n_limbs, 2) int32 (x, y) PAF channels of each limb."""
        return np.asarray(self.paf_channels, dtype=np.int32)


# Only the first 17 COCO limbs may start a person; the last two (the
# ear-shoulder links closing the head cycle) only attach or merge.
COCO18 = Skeleton(
    name="coco18",
    parts=tuple(p.name for p in skeleton.CocoPart)[:skeleton.N_PARTS],
    limbs=skeleton.COCO_PAIRS,
    paf_channels=skeleton.COCO_PAIRS_NETWORK,
    person_limbs=17)

# OpenPose's BODY_25 (`poseParameters.cpp`: the part names, the pair order
# and POSE_MAP_INDEX of PoseModel::BODY_25). person_limbs extends COCO's
# rule: the limbs before the two ear-shoulder links (18, 19) may start a
# person; those links and the six foot limbs after them only join one.
BODY25 = Skeleton(
    name="body25",
    parts=("Nose", "Neck", "RShoulder", "RElbow", "RWrist", "LShoulder",
           "LElbow", "LWrist", "MidHip", "RHip", "RKnee", "RAnkle", "LHip",
           "LKnee", "LAnkle", "REye", "LEye", "REar", "LEar", "LBigToe",
           "LSmallToe", "LHeel", "RBigToe", "RSmallToe", "RHeel"),
    limbs=((1, 8), (1, 2), (1, 5), (2, 3), (3, 4), (5, 6), (6, 7), (8, 9),
           (9, 10), (10, 11), (8, 12), (12, 13), (13, 14), (1, 0), (0, 15),
           (15, 17), (0, 16), (16, 18), (2, 17), (5, 18), (14, 19),
           (19, 20), (14, 21), (11, 22), (22, 23), (11, 24)),
    paf_channels=((0, 1), (14, 15), (22, 23), (16, 17), (18, 19), (24, 25),
                  (26, 27), (6, 7), (2, 3), (4, 5), (8, 9), (10, 11),
                  (12, 13), (30, 31), (32, 33), (36, 37), (34, 35),
                  (38, 39), (20, 21), (28, 29), (40, 41), (42, 43),
                  (44, 45), (46, 47), (48, 49), (50, 51)),
    person_limbs=18)

SKELETONS = (COCO18, BODY25)


def find(**counts: int) -> Skeleton:
    """The skeleton whose counts (`n_parts`, `n_limbs`, `n_heatmaps`,
    `n_pafs`) equal all those given; none raises. Every part of the port
    that works on a skeleton's tensors finds its skeleton here, from their
    shapes."""
    for skel in SKELETONS:
        if all(getattr(skel, key) == n for key, n in counts.items()):
            return skel
    have = ", ".join(f"{s.name} (" + ", ".join(
        f"{key} {getattr(s, key)}" for key in counts) + ")"
        for s in SKELETONS)
    given = ", ".join(f"{key} {n}" for key, n in counts.items())
    raise ValueError(f"no skeleton has {given}; have {have}")


def for_maps(n_heatmaps: int, n_pafs: int) -> Skeleton:
    """The skeleton whose maps have `n_heatmaps` heatmap and `n_pafs` PAF
    channels: (19, 38) COCO18, (26, 52) BODY25; anything else raises."""
    return find(n_heatmaps=n_heatmaps, n_pafs=n_pafs)
