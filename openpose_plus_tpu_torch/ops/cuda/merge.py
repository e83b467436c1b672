"""Sequential subset merge (human assembly): CUDA kernel + plain PyTorch
version.

Replaces the TPU kernel `openpose_plus_tpu/ops/pallas/merge.py ::
assemble_pallas`; kernel source `openpose_plus_tpu_torch/csrc/merge.cu`.
Semantics are bit-identical to `openpose_plus_tpu/postproc/group.py ::
assemble` (the CMU merge with its overwrite-and-count quirk). On the H100
the work is bounded by the serial dependency from one valid connection to
the next, not by bytes: the plain version is ~40 tiny tensor ops per
connection slot (limbs*K slots); the kernel is one launch, a 128-thread block
per image that stages its inputs in shared memory and compacts the valid
slots, then one warp whose chain over them runs in registers and shared
memory only.

`assemble` calls the op `openpose_plus_tpu_torch::assemble` (torch.library),
which dispatches on the device of its inputs: CPU tensors take
`assemble_plain`, CUDA tensors launch the kernel or raise. Each launch adds
one to the module-level `launches` count. The skeleton is the one of the
peak scores' part count (`skeletons.find`: 18 COCO, 25 BODY_25): its
limbs, in the connections' order, and the limbs that may start a person.
"""

from __future__ import annotations

import torch

from openpose_plus_tpu_torch import skeletons
from openpose_plus_tpu_torch.ops import NAMESPACE, check_device, device_cache

MAX_HUMANS = 32        # one warp lane per human row

launches = 0   # kernel launches in this process (see module docstring)


def assemble_plain(slot_a: torch.Tensor, slot_b: torch.Tensor,
                   score: torch.Tensor, valid: torch.Tensor,
                   peak_score: torch.Tensor, max_peaks: int, max_humans: int
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Connections (B, L, K) + peak_score (B, P, K) -> parts (B, M, P)
    int32 global peak ids (part*K + slot, -1 empty), score (B, M) float32,
    count (B, M) int32, P the skeleton's parts. One masked step per
    connection slot in limb-major order, batched over images; float sums
    grouped as in group.assemble."""
    b, n_limbs, k = slot_a.shape
    m = max_humans
    dev = slot_a.device
    skel = skeletons.find(n_parts=peak_score.shape[1], n_limbs=n_limbs)
    n_parts = skel.n_parts
    pairs = skel.pairs_array()
    ridx = torch.arange(m, device=dev)
    bidx = torch.arange(b, device=dev)
    zero_i = torch.zeros((b,), dtype=torch.long, device=dev)
    parts = torch.full((b, m, n_parts), -1, dtype=torch.int32, device=dev)
    subset_score = torch.zeros((b, m), dtype=torch.float32, device=dev)
    count = torch.zeros((b, m), dtype=torch.int32, device=dev)
    ps = peak_score.reshape(b, n_parts * k)
    col = torch.arange(n_parts, device=dev)

    def first(mask: torch.Tensor) -> torch.Tensor:
        # lowest row index where mask (0 when none), as jnp.argmax(mask)
        j = torch.where(mask, ridx, m).amin(dim=1)
        return torch.where(mask.any(dim=1), j, zero_i)

    for limb in range(n_limbs):
        ia, ib = int(pairs[limb, 0]), int(pairs[limb, 1])
        for t in range(k):
            a_gid = (ia * max_peaks + slot_a[:, limb, t]).to(torch.int32)
            b_gid = (ib * max_peaks + slot_b[:, limb, t]).to(torch.int32)
            cscore = score[:, limb, t]
            cvalid = valid[:, limb, t]
            a_ps = ps.gather(1, a_gid.long()[:, None])[:, 0]
            b_ps = ps.gather(1, b_gid.long()[:, None])[:, 0]

            found = ((parts[:, :, ia] == a_gid[:, None])
                     | (parts[:, :, ib] == b_gid[:, None]))     # (B, M)
            nfound = found.sum(dim=1)
            j1 = first(found)
            j2 = first(found & (ridx != j1[:, None]))
            row1, row2 = parts[bidx, j1], parts[bidx, j2]       # (B, P)
            overlap = ((row1 >= 0) & (row2 >= 0)).any(dim=1)
            empty = count == 0
            jnew = first(empty)
            has_empty = empty.any(dim=1)

            attach = cvalid & (((nfound == 1) & (row1[:, ib] != b_gid))
                               | ((nfound == 2) & overlap))
            merge = cvalid & (nfound == 2) & ~overlap
            create = cvalid & (nfound == 0) & (limb < skel.person_limbs) \
                & has_empty

            is1 = ridx == j1[:, None]                              # (B, M)
            is2 = ridx == j2[:, None]
            isn = ridx == jnew[:, None]
            s1 = subset_score[bidx, j1]
            s2 = subset_score[bidx, j2]
            c2 = count[bidx, j2]

            # attach: parts[j1, ib] = b_gid; score[j1] += (b_ps + cscore)
            att_rows = (attach[:, None] & is1)
            parts[:, :, ib] = torch.where(att_rows, b_gid[:, None],
                                          parts[:, :, ib])
            # merge: row j1 <- where(row2 >= 0, row2, row1); clear row j2
            merged = torch.where(row2 >= 0, row2, row1)
            mrg1 = (merge[:, None] & is1)[:, :, None]
            mrg2 = (merge[:, None] & is2)[:, :, None]
            parts = torch.where(mrg1, merged[:, None], parts)
            parts = torch.where(mrg2, torch.full_like(parts, -1), parts)
            # create: row jnew = {ia: a_gid, ib: b_gid, else -1}
            new_row = torch.where(col == ia, a_gid[:, None],
                                  torch.where(col == ib, b_gid[:, None],
                                              torch.full_like(row1, -1)))
            crt = (create[:, None] & isn)
            parts = torch.where(crt[:, :, None], new_row[:, None], parts)

            new1 = torch.where(attach, s1 + (b_ps + cscore),
                               s1 + (s2 + cscore))
            subset_score = torch.where((attach | merge)[:, None] & is1,
                                       new1[:, None], subset_score)
            subset_score = torch.where(merge[:, None] & is2,
                                       torch.zeros_like(subset_score),
                                       subset_score)
            subset_score = torch.where(crt, ((a_ps + b_ps) + cscore)[:, None],
                                       subset_score)
            inc = torch.where(attach, torch.ones_like(c2), c2)
            count = torch.where((attach | merge)[:, None] & is1,
                                count + inc[:, None], count)
            count = torch.where(merge[:, None] & is2,
                                torch.zeros_like(count), count)
            count = torch.where(crt, torch.full_like(count, 2), count)
    return parts, subset_score, count


@device_cache
def limb_pairs(device: torch.device, skeleton: skeletons.Skeleton
               ) -> torch.Tensor:
    """(L, 2) int32 part indices of each of the skeleton's limb endpoints,
    one cached copy per device (the kernel's table; the PAF scorer indexes
    with it too)."""
    return torch.as_tensor(skeleton.pairs_array(), device=device)


_SCHEMA = ("(Tensor slot_a, Tensor slot_b, Tensor score, Tensor valid, "
           "Tensor peak_score, int max_peaks, int max_humans) -> (Tensor, "
           "Tensor, Tensor)")


@torch.library.custom_op(f"{NAMESPACE}::assemble", mutates_args=(),
                         device_types="cpu", schema=_SCHEMA)
def _assemble_op(slot_a: torch.Tensor, slot_b: torch.Tensor,
                 score: torch.Tensor, valid: torch.Tensor,
                 peak_score: torch.Tensor, max_peaks: int, max_humans: int
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    return assemble_plain(slot_a, slot_b, score, valid, peak_score,
                          max_peaks, max_humans)


@_assemble_op.register_fake
def _(slot_a, slot_b, score, valid, peak_score, max_peaks, max_humans):
    b = slot_a.shape[0]
    i32, f32 = torch.int32, torch.float32
    return (slot_a.new_empty((b, max_humans, peak_score.shape[1]), dtype=i32),
            slot_a.new_empty((b, max_humans), dtype=f32),
            slot_a.new_empty((b, max_humans), dtype=i32))


@_assemble_op.register_kernel("cuda")
def _assemble_cuda(slot_a: torch.Tensor, slot_b: torch.Tensor,
                   score: torch.Tensor, valid: torch.Tensor,
                   peak_score: torch.Tensor, max_peaks: int, max_humans: int
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    b, n_limbs, k = slot_a.shape
    skel = skeletons.find(n_parts=peak_score.shape[1], n_limbs=n_limbs)
    expect = {"slot_a": (slot_a, torch.int32, (b, n_limbs, k)),
              "slot_b": (slot_b, torch.int32, (b, n_limbs, k)),
              "score": (score, torch.float32, (b, n_limbs, k)),
              "valid": (valid, torch.bool, (b, n_limbs, k)),
              "peak_score": (peak_score, torch.float32,
                             (b, skel.n_parts, k))}
    for name, (t, dtype, shape) in expect.items():
        if (t.device != slot_a.device or t.dtype != dtype
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(
                f"assemble: {name} must be a contiguous {dtype} {shape} "
                f"tensor on {slot_a.device}, got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}")
    if n_limbs != skel.n_limbs or k != max_peaks:
        raise ValueError(f"assemble: connections {(b, n_limbs, k)} are not "
                         f"(B, {skel.n_limbs}, {max_peaks})")
    if not 1 <= max_humans <= MAX_HUMANS:
        raise ValueError(f"assemble kernel takes max_humans <= "
                         f"{MAX_HUMANS}, got {max_humans}")
    from openpose_plus_tpu_torch.ops.cuda import build

    global launches
    dev = slot_a.device
    parts = torch.empty((b, max_humans, skel.n_parts), dtype=torch.int32,
                        device=dev)
    subset_score = torch.empty((b, max_humans), dtype=torch.float32,
                               device=dev)
    count = torch.empty((b, max_humans), dtype=torch.int32, device=dev)
    if b == 0:
        return parts, subset_score, count
    lib = build.load()
    err = lib.assemble_launch(
        slot_a.data_ptr(), slot_b.data_ptr(), score.data_ptr(),
        valid.data_ptr(), peak_score.data_ptr(),
        limb_pairs(dev, skel).data_ptr(), b, n_limbs, skel.n_parts, k,
        max_humans, skel.person_limbs, parts.data_ptr(),
        subset_score.data_ptr(), count.data_ptr(), dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, err, "assemble_launch")
    launches += 1
    return parts, subset_score, count


def assemble(slot_a: torch.Tensor, slot_b: torch.Tensor, score: torch.Tensor,
             valid: torch.Tensor, peak_score: torch.Tensor, max_peaks: int,
             max_humans: int
             ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Dispatching wrapper (the op); same contract as `assemble_plain`."""
    check_device("assemble", slot_a)
    return _assemble_op(slot_a, slot_b, score, valid, peak_score, max_peaks,
                        max_humans)
