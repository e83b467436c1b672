"""Decode families: how a network's maps become people, plainly. A network
file names its family (`FAMILY`); the family is the file
`reference/families/<name>.py` beside this one, found by that name, and
gives

    STRUCTURE              the printed name of its structure number
    skeleton(net)          the network's skeleton, with `n_parts`
    head_rule(net, model, skeleton)
                           [(head prefix, map index, channels, weight key)]:
                           the output channels (a slice, or None for all)
                           of a head's conv that `harness.weights` centres
                           and scales so that those channels of map `map
                           index` peak at the configuration's
                           `weights[weight key]`
    read(model, sd, x, postproc, skeleton) -> Readings
                           the readings of a block of uint8 images, in
                           float32 and with what a bf16 network stores
                           rounded to bf16
    decode(maps, postproc, skeleton, extent) -> (people, heat planes)
                           the people of each image of maps as
                           `models.forward` gives them, on a decode grid
                           of `extent` (H, W) where the family does not
                           set it itself, (coords (P, parts,
                           2) normalized, NaN where a part is absent;
                           scores (P,); part scores (P, parts); the part
                           counts (P,) the decoder reports), and the heat
                           planes on the decode grid
    structure_breaks(xy, structure, postproc) -> (checked, broken)
                           what holds people `xy` together (their parts'
                           links, their tags) that the family's own
                           structure data of their image checks, and what
                           of it breaks
    init(name, shape, generator)
                           optional: a tensor the default weight draw must
                           not make, or None

The program's side of a family (its decoder, timed) is
`harness/families/<name>.py`.
"""

from __future__ import annotations

import dataclasses
import types


@dataclasses.dataclass
class Readings:
    """The reference's readings of a sample, image by image: the heat
    planes (H, W, >= parts) on the decode grid in float32 and bf16-stored,
    the float32 peaks of each part (`ys`, `xs` a part), both sides' people
    (as `decode` gives them), the family's structure data; the decode
    grid's extent (H, W), the pairing tolerance (one cell of the network's
    finest output, in pixels of the decode grid), the skeleton and the
    family (which the caller sets)."""

    maps: list = dataclasses.field(default_factory=list)
    maps16: list = dataclasses.field(default_factory=list)
    peaks: list = dataclasses.field(default_factory=list)
    people: list = dataclasses.field(default_factory=list)
    people16: list = dataclasses.field(default_factory=list)
    structure: list = dataclasses.field(default_factory=list)
    extent: tuple = ()
    tol: float = 0.0
    skeleton: object = None
    family: types.ModuleType = None

    @property
    def n_parts(self) -> int:
        return self.skeleton.n_parts

    def extend(self, block: "Readings") -> None:
        """Append a block's readings."""
        for f in ("maps", "maps16", "peaks", "people", "people16",
                  "structure"):
            getattr(self, f).extend(getattr(block, f))
        self.extent, self.tol = block.extent, block.tol
        self.skeleton = block.skeleton
