"""The port's hand-written CUDA kernels against their plain PyTorch versions,
on the card.

Marked `cuda`: every test skips without a CUDA device. This file imports
neither JAX nor the repository's conftest, so it runs on a GPU machine that
has no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda.py

It covers what chip_smoke.py's main-path shapes do not: every register
tiling of the greedy kernel (K from 1 to 32), merge tables with fewer than
32 rows, an empty batch, and the wrappers' refusals on the card.
"""

import numpy as np
import pytest
import torch

# pytest puts this directory on sys.path; `from tests import ...` would
# break where an installed package named `tests` shadows it
import kernel_inputs
from openpose_plus_tpu_torch.ops.cuda import greedy, merge

pytestmark = pytest.mark.cuda

torch.set_num_threads(2)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _scores(rng, b, k, density):
    return torch.from_numpy(kernel_inputs.limb_scores(rng, b, k, density))


def _conns(rng, b, k):
    fields = (*kernel_inputs.connections(rng, b, k),
              kernel_inputs.peak_scores(rng, b, k))
    return [torch.from_numpy(x) for x in fields]


# K*K/32 candidates per lane: 1 (K <= 5), 2, 4, 8, 16 and 32 (K = 32)
@pytest.mark.parametrize("k", [1, 2, 5, 7, 8, 11, 16, 22, 23, 32])
@pytest.mark.parametrize("density", [0.3, 1.0])
def test_greedy_kernel_equals_plain(cuda, k, density):
    scores = _scores(np.random.default_rng(k), 5, k, density)
    before = greedy.launches
    out = greedy.greedy_assign(scores.to(cuda), k)
    torch.cuda.synchronize()
    assert greedy.launches == before + 1
    for o, r in zip(out, greedy.greedy_assign_plain(scores, k)):
        assert o.device.type == "cuda" and torch.equal(o.cpu(), r)


@pytest.mark.parametrize("k,m", [(1, 1), (4, 4), (8, 16), (16, 7),
                                 (16, 32), (32, 31), (32, 32)])
def test_merge_kernel_equals_plain(cuda, k, m):
    rng = np.random.default_rng(100 + k * m)
    args = _conns(rng, 6, k)
    before = merge.launches
    out = merge.assemble(*[t.to(cuda) for t in args], k, m)
    torch.cuda.synchronize()
    assert merge.launches == before + 1
    for o, r in zip(out, merge.assemble_plain(*args, k, m)):
        assert o.device.type == "cuda" and torch.equal(o.cpu(), r)


def test_merge_kernel_on_greedy_output(cuda):
    """The two kernels chained as the decoder chains them."""
    rng = np.random.default_rng(7)
    scores = _scores(rng, 8, 16, 0.3)
    conns = greedy.greedy_assign(scores.to(cuda), 16)
    peak_score = torch.from_numpy(kernel_inputs.peak_scores(rng, 8, 16))
    out = merge.assemble(*conns, peak_score.to(cuda), 16, 32)
    ref = merge.assemble_plain(*greedy.greedy_assign_plain(scores, 16),
                               peak_score, 16, 32)
    for o, r in zip(out, ref):
        assert torch.equal(o.cpu(), r)


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    """On the card a wrapper launches its kernel or raises; it never falls
    back to the plain version."""
    scores = _scores(np.random.default_rng(0), 2, 16, 0.3).to(cuda)
    with pytest.raises(ValueError):
        greedy.greedy_assign(scores.double(), 16)
    with pytest.raises(ValueError):
        greedy.greedy_assign(scores.transpose(2, 3), 16)
    with pytest.raises(ValueError):
        greedy.greedy_assign(scores[:, :18].contiguous(), 16)
    big = torch.zeros((1, 19, 33, 33), device=cuda)
    with pytest.raises(ValueError, match="K <= 32"):
        greedy.greedy_assign(big, 33)
    args = [t.to(cuda) for t in _conns(np.random.default_rng(1), 2, 16)]
    with pytest.raises(ValueError, match="max_humans <= 32"):
        merge.assemble(*args, 16, 33)
    with pytest.raises(ValueError):
        merge.assemble(*args[:4], args[4].cpu(), 16, 32)
    with pytest.raises(ValueError):
        merge.assemble(args[0].long(), *args[1:], 16, 32)


def test_empty_batch_launches_nothing(cuda):
    """A batch of 0 images returns empty outputs and launches no kernel."""
    scores = torch.zeros((0, 19, 16, 16), device=cuda)
    args = [t.to(cuda) for t in _conns(np.random.default_rng(2), 0, 16)]
    before = (greedy.launches, merge.launches)
    out = greedy.greedy_assign(scores, 16) + merge.assemble(*args, 16, 32)
    assert (greedy.launches, merge.launches) == before
    assert [tuple(t.shape) for t in out] == [
        (0, 19, 16)] * 4 + [(0, 32, 18), (0, 32), (0, 32)]
