"""Sequential subset merge (human assembly): CUDA kernel + plain PyTorch
version.

Replaces the TPU kernel `openpose_plus_tpu/ops/pallas/merge.py ::
assemble_pallas`; kernel source `openpose_plus_tpu_torch/csrc/merge.cu`.
Semantics are bit-identical to `openpose_plus_tpu/postproc/group.py ::
assemble` (the CMU merge with its overwrite-and-count quirk). On the H100
the work is bounded by launch latency and the serial dependency from one
connection to the next, not by bytes: the plain version is ~40 tiny tensor
ops per connection slot (19*K slots), the kernel one launch with one warp
per image.

`assemble` dispatches on the device of its inputs: CPU tensors take
`assemble_plain`, CUDA tensors launch the kernel or raise. Each launch adds
one to the module-level `launches` count.
"""

from __future__ import annotations

import functools

import torch

from openpose_plus_tpu import skeleton

N_PARTS = skeleton.N_PARTS
MAX_HUMANS = 32        # one warp lane per human row
# Only the first 17 limbs may start a new human; the last two (ear-shoulder
# links closing the head cycle) only attach or merge.
N_CREATE_LIMBS = 17

launches = 0   # kernel launches in this process (see module docstring)


def assemble_plain(slot_a: torch.Tensor, slot_b: torch.Tensor,
                   score: torch.Tensor, valid: torch.Tensor,
                   peak_score: torch.Tensor, max_peaks: int, max_humans: int
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Connections (B, L, K) + peak_score (B, 18, K) -> parts (B, M, 18)
    int32 global peak ids (part*K + slot, -1 empty), score (B, M) float32,
    count (B, M) int32. One masked step per connection slot in limb-major
    order, batched over images; float sums grouped as in group.assemble."""
    b, n_limbs, k = slot_a.shape
    m = max_humans
    dev = slot_a.device
    pairs = skeleton.pairs_array()
    ridx = torch.arange(m, device=dev)
    bidx = torch.arange(b, device=dev)
    zero_i = torch.zeros((b,), dtype=torch.long, device=dev)
    parts = torch.full((b, m, N_PARTS), -1, dtype=torch.int32, device=dev)
    subset_score = torch.zeros((b, m), dtype=torch.float32, device=dev)
    count = torch.zeros((b, m), dtype=torch.int32, device=dev)
    ps = peak_score.reshape(b, N_PARTS * k)
    col = torch.arange(N_PARTS, device=dev)

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
            row1, row2 = parts[bidx, j1], parts[bidx, j2]       # (B, 18)
            overlap = ((row1 >= 0) & (row2 >= 0)).any(dim=1)
            empty = count == 0
            jnew = first(empty)
            has_empty = empty.any(dim=1)

            attach = cvalid & (((nfound == 1) & (row1[:, ib] != b_gid))
                               | ((nfound == 2) & overlap))
            merge = cvalid & (nfound == 2) & ~overlap
            create = cvalid & (nfound == 0) & (limb < N_CREATE_LIMBS) \
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


@functools.lru_cache(maxsize=None)
def limb_pairs(device: torch.device) -> torch.Tensor:
    """(L, 2) int32 part indices of each limb's endpoints, one cached copy
    per device (the kernel's table; the PAF scorer indexes with it too)."""
    return torch.as_tensor(skeleton.pairs_array(), device=device)


def assemble(slot_a: torch.Tensor, slot_b: torch.Tensor, score: torch.Tensor,
             valid: torch.Tensor, peak_score: torch.Tensor, max_peaks: int,
             max_humans: int
             ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Dispatching wrapper; same contract as `assemble_plain`."""
    if slot_a.device.type == "cpu":
        return assemble_plain(slot_a, slot_b, score, valid, peak_score,
                              max_peaks, max_humans)
    if slot_a.device.type != "cuda":
        raise ValueError(f"assemble: unsupported device {slot_a.device}")
    b, n_limbs, k = slot_a.shape
    expect = {"slot_a": (slot_a, torch.int32, (b, n_limbs, k)),
              "slot_b": (slot_b, torch.int32, (b, n_limbs, k)),
              "score": (score, torch.float32, (b, n_limbs, k)),
              "valid": (valid, torch.bool, (b, n_limbs, k)),
              "peak_score": (peak_score, torch.float32, (b, N_PARTS, k))}
    for name, (t, dtype, shape) in expect.items():
        if (t.device != slot_a.device or t.dtype != dtype
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(
                f"assemble: {name} must be a contiguous {dtype} {shape} "
                f"tensor on {slot_a.device}, got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}")
    if n_limbs != skeleton.N_LIMBS or k != max_peaks:
        raise ValueError(f"assemble: connections {(b, n_limbs, k)} are not "
                         f"(B, {skeleton.N_LIMBS}, {max_peaks})")
    if not 1 <= max_humans <= MAX_HUMANS:
        raise ValueError(f"assemble kernel takes max_humans <= "
                         f"{MAX_HUMANS}, got {max_humans}")
    from openpose_plus_tpu_torch.ops.cuda import build

    global launches
    dev = slot_a.device
    parts = torch.empty((b, max_humans, N_PARTS), dtype=torch.int32,
                        device=dev)
    subset_score = torch.empty((b, max_humans), dtype=torch.float32,
                               device=dev)
    count = torch.empty((b, max_humans), dtype=torch.int32, device=dev)
    if b == 0:
        return parts, subset_score, count
    lib = build.load()
    err = lib.assemble_launch(
        slot_a.data_ptr(), slot_b.data_ptr(), score.data_ptr(),
        valid.data_ptr(), peak_score.data_ptr(), limb_pairs(dev).data_ptr(),
        b, n_limbs, k, max_humans, N_CREATE_LIMBS, parts.data_ptr(),
        subset_score.data_ptr(), count.data_ptr(), dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, err, "assemble_launch")
    launches += 1
    return parts, subset_score, count
