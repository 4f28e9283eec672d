"""The spatial axis's row partition and halo exchanges, in one process.

Every convolution of the ResNet-50 and its max-pool, at 224x224 and 64x64
crops, over spatial axes of 2, 3 and 4: a whole float64 activation is split
by mesh.row_range, each simulated rank builds its input window through
RowShards.exchange (the ranks run on threads, their sends and receives
carried by in-memory mailboxes instead of torch.distributed), runs the
layer on it with the row padding already in the window, and the ranks'
outputs, concatenated, must equal the layer on the whole tensor within
1e-12. At 64x64 and 4 ranks some ranks own no rows of a layer, and hold
none of its output. The forward of whole layouts is tested on gloo ranks in
tests/test_torch_parallel_ranks.py.
"""

import queue
import threading

import pytest
import torch
import torch.nn.functional as F

from poserisk_release_tpu_torch.models.spin import HMR
from poserisk_release_tpu_torch.parallel import mesh as pmesh
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

W = 5  # columns: the column padding stays with the layer, so a few do


def layer_geometries(hw):
    """(name, input height, kernel, stride, padding, is the max-pool) of
    every conv and the max-pool of the HMR's ResNet-50 on hw x hw crops, by
    forward hooks on the module."""
    model = HMR().eval()
    seen = []

    def hook(module, args, _out):
        k, s, p = (module.kernel_size, module.stride, module.padding)
        k, s, p = (v if isinstance(v, int) else v[0] for v in (k, s, p))
        seen.append((names[module], args[0].shape[2], k, s, p,
                     isinstance(module, torch.nn.MaxPool2d)))

    names = {m: n for n, m in model.named_modules()
             if isinstance(m, (torch.nn.Conv2d, torch.nn.MaxPool2d))}
    handles = [m.register_forward_hook(hook) for m in names]
    with torch.inference_mode():
        model.features(torch.zeros(1, 3, hw, hw))
    for h in handles:
        h.remove()
    return seen


GEOMETRIES = {hw: layer_geometries(hw) for hw in (224, 64)}


class _Group:
    def __init__(self, rank):
        self.rank = rank


def _mailbox_exchange(boxes):
    """collectives.exchange over in-memory queues: each (src, dst) pair has
    a queue; a send must meet a receive of the same shape."""

    def exchange(sends, recvs, group, like):
        for x, dst in sends:
            boxes[(group.rank, dst)].put(x.clone())
        got = []
        for shape, src in recvs:
            t = boxes[(src, group.rank)].get(timeout=30)
            assert tuple(t.shape) == tuple(shape), (src, group.rank, t.shape, shape)
            got.append(t)
        return got

    return exchange


def run_sharded(whole, size, k, s, p, layer, monkeypatch):
    """Each simulated rank's output of `layer` on its window of `whole`
    (row_range shards, RowShards.exchange), in rank order, and the bytes
    the ranks received."""
    H = whole.shape[2]
    boxes = {(a, b): queue.Queue() for a in range(size) for b in range(size)}
    monkeypatch.setattr(pmesh.collectives, "exchange", _mailbox_exchange(boxes))
    pmesh.RowShards.received_bytes = 0
    outs, errors = [None] * size, []

    def rank(r):
        try:
            h0, h1 = pmesh.row_range(H, size, r)
            rows = pmesh.RowShards(_Group(r), size, r, ranks=range(size))
            win = rows.exchange(whole[:, :, h0:h1], H, k, s, p)
            o0, o1 = pmesh.row_range(pmesh.conv_height(H, k, s, p), size, r)
            assert win.shape[2] == (0 if o1 <= o0 else (o1 - 1 - o0) * s + k)
            outs[r] = layer(win, (0, p)) if win.shape[2] else None
        except BaseException as exc:  # surfaced in the parent
            errors.append(exc)

    threads = [threading.Thread(target=rank, args=(r,)) for r in range(size)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    if errors:
        raise errors[0]
    assert all(q.empty() for q in boxes.values()), "a send met no receive"
    return outs, pmesh.RowShards.received_bytes


def rows_missing(H, size, k, s, p):
    """The input rows the ranks read and do not own, over all ranks,
    counted straight from the partition rule: rank r owns
    [min(r c, H), min((r + 1) c, H)), c = ceil(H / size), of the input and
    likewise of the output, and its output rows [o0, o1) read the input
    rows [o0 s - p, (o1 - 1) s - p + k)."""
    ho = (H + 2 * p - k) // s + 1
    c, co = -(-H // size), -(-ho // size)
    n = 0
    for r in range(size):
        o0, o1 = min(r * co, ho), min((r + 1) * co, ho)
        if o1 > o0:
            need = set(range(max(o0 * s - p, 0), min((o1 - 1) * s - p + k, H)))
            n += len(need - set(range(min(r * c, H), min((r + 1) * c, H))))
    return n


@pytest.mark.parametrize("size", [2, 3, 4])
@pytest.mark.parametrize("hw", [224, 64])
def test_every_layer_split_over_rows_equals_the_whole_layer(hw, size, monkeypatch):
    g = torch.Generator().manual_seed(hw + size)
    n_empty = 0
    for name, H, k, s, p, pool in GEOMETRIES[hw]:
        whole = torch.randn(1, 2, H, W, generator=g, dtype=torch.float64)
        if pool:  # the max-pool reads post-ReLU activations
            whole = whole.abs()

            def layer(x, pad):
                return F.max_pool2d(x, k, s, padding=pad)
        else:
            weight = torch.randn(3, 2, k, k, generator=g, dtype=torch.float64)

            def layer(x, pad):
                return F.conv2d(x, weight, stride=s, padding=pad)

        want = layer(whole, (p, p))
        outs, received = run_sharded(whole, size, k, s, p, layer, monkeypatch)
        n_empty += sum(o is None for o in outs)
        for r, out in enumerate(outs):
            o0, o1 = pmesh.row_range(want.shape[2], size, r)
            assert (out is None) == (o1 <= o0), (name, r)
        got = torch.cat([o for o in outs if o is not None], dim=2)
        torch.testing.assert_close(got, want, rtol=0, atol=1e-12, msg=name)
        # Only the rows a rank reads and lacks travel: never a whole activation.
        row_bytes = whole[:, :, :1].numel() * whole.element_size()
        assert received == rows_missing(H, size, k, s, p) * row_bytes, name
    if hw == 64 and size == 4:
        assert n_empty > 0  # layer4's 2 rows leave ranks 2 and 3 empty


def test_the_stem_window_comes_from_the_whole_crops():
    """RowShards.take cuts each rank's stem window out of the crops every
    rank holds, with zero rows past the edges: no exchange."""
    g = torch.Generator().manual_seed(0)
    crops = torch.rand(2, 3, 64, 64, generator=g, dtype=torch.float64)
    weight = torch.randn(4, 3, 7, 7, generator=g, dtype=torch.float64)
    want = F.conv2d(crops, weight, stride=2, padding=3)
    for size in (2, 3, 4):
        parts = []
        for r in range(size):
            win = pmesh.RowShards(None, size, r, ranks=range(size)).take(crops, 7, 2, 3)
            parts.append(F.conv2d(win, weight, stride=2, padding=(0, 3)))
        torch.testing.assert_close(torch.cat(parts, dim=2), want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8])
def test_bf16_and_int8_rows_travel_as_they_are(dtype, monkeypatch):
    """The exchange moves rows bit for bit whatever their type."""
    whole = (torch.arange(2 * 3 * 9 * W) % 101 - 50).reshape(2, 3, 9, W).to(dtype)
    outs, received = run_sharded(whole, 3, 3, 1, 1, lambda x, pad: x, monkeypatch)
    for r, win in enumerate(outs):
        a = r * 3 - 1
        rows = [max(a, 0), min(a + 5, 9)]
        assert torch.equal(win[:, :, max(0, -a):max(0, -a) + rows[1] - rows[0]],
                           whole[:, :, rows[0]:rows[1]])
    # ranks 0 and 2 receive one row each, rank 1 two: 4 rows in all
    assert received == 4 * 2 * 3 * W * whole.element_size()
