"""The meta path of the kernels and the dry run (``launch/dryrun.py``), on
the CPU.

- Each kernel entry point (``ops.attention``, ``ops.mamba_scan``,
  ``ops.grouped_matmul_aligned``) and autograd Function on meta tensors
  returns the plain version's output shapes and dtypes (the plain version
  run first on CPU tensors of the same shapes), with gradients of the
  inputs' shapes and dtypes, counts one call in ``ops.meta_calls`` and its
  bound's FLOPs and bytes in ``ops.meta_cost``, counts no launch, and
  never reaches ``ref`` (monkeypatched to raise once the plain outputs are
  in hand).  A tensor on another device raises.
- ``run_cell`` on reduced dense (deepseek-7b) and MoE (olmoe-1b-7b)
  configs at head dim 64 (a head dim the backward kernels take), remat
  "full" for training: the parameters it counts are the port's leaves,
  the training state the parameters' own bytes and 12 B a parameter (f32
  master, m, v), the kernel calls those of the step, and its counted FLOPs against
  ``step_cost``'s pinned per family and kind at the ratios found, within
  1e-6 relative (the counts are exact; the tolerance absorbs float sums).
  Prefill is off by more than 10 % in both families (1.38, 1.34): the
  port's prefill runs a second pass over each layer's input for its cache
  (``Model._prefill_layer_cache``: the K/V projections again), which
  ``step_cost``'s prefill does not count.  Under remat "dots" the counted
  FLOPs exceed ``step_cost``'s (1.08, 1.15), whose forward multiplier for
  "dots" is that of "none" (3): the port recomputes the kernels'
  Functions (attention, the grouped products) as JAX recomputes a Pallas
  call.
- ``MetaMemory``'s peak on a case counted by hand, and the CLI's JSON
  outside ``benchmarks/`` (hymba-1.5b at ``train_4k``, its full size:
  about 10 s on meta).
"""
import dataclasses
import json
import types

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config, reduce_config  # noqa: E402
from repro_torch.configs.shapes import Shape  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import mamba_scan as ms  # noqa: E402
from repro_torch.kernels import moe_gmm, ops, ref  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402

META = torch.device("meta")
_PLAIN = ("attention_ref", "mamba_scan_ref", "grouped_matmul_ref",
          "grouped_matmul_aligned_ref", "attention_bwd_ref",
          "mamba_scan_bwd_ref", "grouped_matmul_aligned_bwd_ref",
          "rmsnorm_ref", "rope_ref", "causal_conv_ref", "silu_gate_ref",
          "rmsnorm_bwd_ref", "rope_bwd_ref", "causal_conv_bwd_ref",
          "silu_gate_bwd_ref")


def _forbid_plain(monkeypatch) -> dict:
    """Every plain version raises from now on; the meta counts start from
    0; returns the launch counts, which must not move."""
    def boom(*a, **k):
        raise AssertionError("a meta tensor reached a plain version")
    for name in _PLAIN:
        monkeypatch.setattr(ref, name, boom)
    ops.reset_meta_cost()
    return dict(ops.launches)


def _rand(shape, dtype, seed=0, grad=False):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g).to(dtype).requires_grad_(grad)


def _meta(t: torch.Tensor) -> torch.Tensor:
    return torch.empty(t.shape, dtype=t.dtype, device=META).requires_grad_(
        t.requires_grad)


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.is_meta and (tuple(a.shape), a.dtype) == (tuple(b.shape),
                                                       b.dtype)


# (dtype, B, Sq, Sk, H, KV, hd, hd_v, causal, window, positions)
ATTN = [(torch.bfloat16, 2, 64, 64, 4, 2, 64, 64, True, 0, False),
        (torch.bfloat16, 2, 64, 64, 4, 2, 64, 64, True, 16, False),
        (torch.float32, 2, 48, 48, 4, 4, 80, 80, False, 0, False),
        (torch.bfloat16, 1, 32, 32, 2, 2, 192, 128, True, 0, False),
        (torch.float32, 2, 1, 40, 4, 1, 32, 32, True, 0, True),
        (torch.bfloat16, 2, 16, 24, 4, 2, 16, 16, True, 0, False)]


@pytest.mark.parametrize("case", ATTN, ids=lambda c: "-".join(
    map(str, c[1:])) + "-" + str(c[0]).removeprefix("torch."))
def test_attention_on_meta(case, monkeypatch):
    dt, B, Sq, Sk, H, KV, hd, hdv, causal, window, positions = case
    q, k, v = (_rand(s, dt, i) for i, s in enumerate(
        ((B, Sq, H, hd), (B, Sk, KV, hd), (B, Sk, KV, hdv))))
    kw = dict(causal=causal, window=window)
    if positions:
        kw["q_pos"] = torch.full((B, Sq), Sk - 1, dtype=torch.int32)
        kw["k_pos"] = torch.arange(Sk, dtype=torch.int32).expand(
            B, Sk).contiguous()
    want = ref.attention_ref(q, k, v, **kw)
    launches = _forbid_plain(monkeypatch)
    mkw = {n: (_meta(t) if torch.is_tensor(t) else t) for n, t in kw.items()}
    out = ops.attention(_meta(q), _meta(k), _meta(v), **mkw)
    assert _same(out, want)
    counter = "attention_masked" if window or positions else \
        "flash_attention"
    assert {c: n for c, n in ops.meta_calls.items() if n} == {counter: 1}
    n_pos = B * (Sq + Sk) if positions else 0
    flops, nbytes = fa.attention_cost(dt.itemsize, B, Sq, Sk, H, KV, hd,
                                      hdv, causal, window, n_pos)
    assert (ops.meta_cost["flops"], ops.meta_cost["bytes"]) == (flops,
                                                                nbytes)
    assert ops.launches == launches


def test_attention_cost_counts_the_live_pairs():
    assert fa.live_pairs(64, 64, True, 0) == 64 * 65 // 2
    assert fa.live_pairs(64, 64, False, 0) == 64 * 64
    assert fa.live_pairs(64, 64, True, 16) == 16 * 17 // 2 + 48 * 16
    assert fa.live_pairs(5, 3, True, 0) == 1 + 2 + 3 + 3 + 3
    f, b = fa.attention_cost(2, 1, 4, 4, 1, 1, 8, 8, False, 0)
    assert (f, b) == (2 * 16 * 16, 2 * 4 * 16 * 2)


# the training calls: (dtype, B, S, H, KV, hd, hd_v, causal, window)
ATTN_TRAIN = [(torch.bfloat16, 2, 64, 4, 2, 64, 64, True, 16),
              (torch.float32, 2, 48, 4, 4, 80, 80, False, 0),
              (torch.bfloat16, 1, 32, 2, 2, 192, 128, True, 0)]


@pytest.mark.parametrize("case", ATTN_TRAIN, ids=lambda c: "-".join(
    map(str, c[1:])) + "-" + str(c[0]).removeprefix("torch."))
def test_attention_function_on_meta(case, monkeypatch):
    dt, B, S, H, KV, hd, hdv, causal, window = case
    q, k, v = (_rand(s, dt, i, grad=True) for i, s in enumerate(
        ((B, S, H, hd), (B, S, KV, hd), (B, S, KV, hdv))))
    want = ref.attention_ref(q, k, v, causal=causal, window=window)
    want.float().sum().backward()
    launches = _forbid_plain(monkeypatch)
    qm, km, vm = _meta(q), _meta(k), _meta(v)
    out = ops.attention(qm, km, vm, causal=causal, window=window)
    assert _same(out, want) and out.grad_fn is not None
    out.float().sum().backward()
    for m, c in ((qm, q), (km, k), (vm, v)):
        assert _same(m.grad, c.grad)
    route = fa.bwd_route(dt, S, S, hd, hdv, window, False)
    assert route == ("tc" if dt == torch.bfloat16 else "general")
    counter = "attention_masked" if window else "flash_attention"
    assert {c: n for c, n in ops.meta_calls.items() if n} == {
        counter: 1, "attention_bwd": 1}
    # both backward routes take the forward's LSE: the forward writes it
    f_fwd, b_fwd = fa.attention_cost(dt.itemsize, B, S, S, H, KV, hd, hdv,
                                     causal, window, with_lse=True)
    f_bwd, b_bwd = fa.attention_bwd_cost(dt.itemsize, B, S, S, H, KV, hd,
                                         hdv, causal, window)
    # five products a live pair and q head: S, dQ, dK of 2 hd FLOPs, dP
    # and dV of 2 hd_v
    assert f_bwd == 2 * (3 * hd + 2 * hdv) * H * B * fa.live_pairs(
        S, S, causal, window)
    assert ops.meta_cost == {"flops": f_fwd + f_bwd, "bytes": b_fwd + b_bwd}
    assert ops.launches == launches


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("state", [False, True])
def test_scan_on_meta(dt, state, monkeypatch):
    B, S, di, N = 2, 24, 16, 4
    u, dtv = _rand((B, S, di), dt, 0), _rand((B, S, di), dt, 1).abs()
    A = -torch.arange(1, N + 1, dtype=torch.float32).expand(
        di, N).contiguous()
    Bc, Cc = _rand((B, S, N), dt, 2), _rand((B, S, N), dt, 3)
    D = _rand((di,), torch.float32, 4)
    h0 = _rand((B, di, N), torch.float32, 5) if state else None
    y, last = ref.mamba_scan_ref(u, dtv, A, Bc, Cc, D, init_state=h0)
    launches = _forbid_plain(monkeypatch)
    ym, lastm = ops.mamba_scan(*(_meta(t) for t in (u, dtv, A, Bc, Cc, D)),
                               init_state=None if h0 is None else _meta(h0))
    assert _same(ym, y) and _same(lastm, last)
    counter = "mamba_step" if state else "mamba_scan"
    assert {c: n for c, n in ops.meta_calls.items() if n} == {counter: 1}
    assert (ops.meta_cost["flops"], ops.meta_cost["bytes"]) == ms.scan_cost(
        dt.itemsize, B, S, di, N, state)
    assert ops.launches == launches


def test_scan_function_on_meta(monkeypatch):
    B, S, di, N, dt = 2, 24, 16, 4, torch.bfloat16
    ins = [_rand((B, S, di), dt, 0, True), _rand((B, S, di), dt, 1, True),
           _rand((di, N), torch.float32, 2, True),
           _rand((B, S, N), dt, 3, True), _rand((B, S, N), dt, 4, True),
           _rand((di,), torch.float32, 5, True)]
    y, _ = ref.mamba_scan_ref(*ins)
    y.float().sum().backward()
    launches = _forbid_plain(monkeypatch)
    metas = [_meta(t) for t in ins]
    ym, lastm = ops.mamba_scan(*metas)
    assert _same(ym, y) and ym.grad_fn is not None
    ym.float().sum().backward()
    for m, c in zip(metas, ins):
        assert _same(m.grad, c.grad)
    assert {c: n for c, n in ops.meta_calls.items() if n} == {
        "mamba_scan": 1, "mamba_scan_bwd": 1}
    fwd = ms.scan_cost(2, B, S, di, N, False)
    bwd = ms.scan_cost(2, B, S, di, N, False, backward=True)
    assert ops.meta_cost == {"flops": fwd[0] + bwd[0],
                             "bytes": fwd[1] + bwd[1]}
    assert ops.launches == launches


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fills", [False, True])
@pytest.mark.parametrize("grad", [False, True])
def test_grouped_matmul_on_meta(dt, fills, grad, monkeypatch):
    G, C, D, F = 4, 24, 16, 32
    x, w = _rand((G * C, D), dt, 0, grad), _rand((G, D, F), dt, 1, grad)
    f = torch.tensor([24, 3, 0, 10], dtype=torch.int32) if fills else None
    want = ref.grouped_matmul_aligned_ref(x, w, C, f)
    if grad:
        want.float().sum().backward()
    launches = _forbid_plain(monkeypatch)
    xm, wm = _meta(x), _meta(w)
    out = ops.grouped_matmul_aligned(xm, wm, C,
                                     None if f is None else _meta(f))
    assert _same(out, want)
    cost = moe_gmm.gmm_cost(dt.itemsize, G, C, D, F, fills)
    calls = {"grouped_matmul": 1}
    if grad:
        out.float().sum().backward()
        assert _same(xm.grad, x.grad) and _same(wm.grad, w.grad)
        calls["grouped_matmul_bwd"] = 1
        for part in ("dx", "dw"):
            c = moe_gmm.gmm_cost(dt.itemsize, G, C, D, F, fills, part)
            cost = (cost[0] + c[0], cost[1] + c[1])
    assert {c: n for c, n in ops.meta_calls.items() if n} == calls
    assert (ops.meta_cost["flops"], ops.meta_cost["bytes"]) == cost
    assert ops.launches == launches


def test_use_kernel_by_device():
    assert ops.use_kernel(torch.empty(1, device=META))
    assert not ops.use_kernel(torch.empty(1))
    other = types.SimpleNamespace(is_cuda=False, is_meta=False,
                                  device=torch.device("xpu"))
    with pytest.raises(ValueError, match="xpu"):
        ops.use_kernel(other)


def test_model_on_meta_takes_no_generator():
    cfg = reduce_config(get_config("hymba-1.5b"))
    model = Model(cfg, device="meta")
    assert all(p.is_meta for p in model.parameters())
    assert sum(p.numel() for p in model.parameters()) == sum(
        p.numel() for p in Model(cfg, device="cpu").parameters())


def _cfg(arch: str, **kw):
    return reduce_config(get_config(arch)).with_(head_dim=64, **kw)


def _fields(cfg) -> dict:
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
            if f.name != "name"}


# the counted FLOPs over step_cost's, per family and kind (remat "full"
# in training), as found; and the kernel calls of the step
# the fused elementwise kernels of one layer: a training step's (remat
# "full": the layer's two norms, two ropes and gate twice, one backward
# each; the final norm once), prefill's (the cache pass's norm and key
# rope again) and decode's
FUSED_TRAIN = {"rmsnorm": 5, "rmsnorm_bwd": 3, "rope": 4, "rope_bwd": 2,
               "silu_gate": 2, "silu_gate_bwd": 1}
FUSED_PREFILL = {"rmsnorm": 4, "rope": 3, "silu_gate": 1}
FUSED_DECODE = {"rmsnorm": 3, "rope": 2, "silu_gate": 1}
RATIOS = {("deepseek-7b", "train"): (0.988502358490566, {
              "flash_attention": 2, "attention_bwd": 1, **FUSED_TRAIN}),
          ("deepseek-7b", "prefill"): (1.3808962264150944, {
              "flash_attention": 1, **FUSED_PREFILL}),
          ("deepseek-7b", "decode"): (1.0, {"attention_masked": 1,
                                           **FUSED_DECODE}),
          ("olmoe-1b-7b", "train"): (1.0, {
              "flash_attention": 2, "grouped_matmul": 6, "attention_bwd": 1,
              "grouped_matmul_bwd": 3, **FUSED_TRAIN}),
          ("olmoe-1b-7b", "prefill"): (1.337539432176656, {
              "flash_attention": 1, "grouped_matmul": 3, **FUSED_PREFILL}),
          ("olmoe-1b-7b", "decode"): (1.0009727626459144, {
              "attention_masked": 1, "grouped_matmul": 3, **FUSED_DECODE})}


@pytest.mark.parametrize("arch,kind", list(RATIOS))
def test_run_cell_reduced(arch, kind, monkeypatch):
    cfg = _cfg(arch, remat="full")
    params = list(Model(cfg, device="cpu").parameters())
    leaves = sum(p.numel() for p in params)
    # the parameters as they are (bf16, the norms f32), then f32 master, m
    # and v
    state = sum(p.numel() * p.element_size() for p in params) + 12 * leaves
    launches = _forbid_plain(monkeypatch)
    r = dryrun.run_cell(arch, Shape(f"r_{kind}", 64, 2, kind),
                        overrides=_fields(cfg))
    ratio, calls = RATIOS[(arch, kind)]
    assert r["status"] == "ok" and r["chips"] == 1
    assert r["leaves"] == leaves == r["params"]
    assert r["state_bytes"] == (state if kind == "train" else None)
    # a training step also makes the fused AdamW's call, one a leaf
    assert r["kernel_calls"] == (dict(calls, adamw=len(params))
                                 if kind == "train" else calls)
    assert r["cost"]["flops"] / r["step_cost"]["flops"] == pytest.approx(
        ratio, rel=1e-6)
    assert r["collectives"]["total_bytes"] == 0
    mem = r["memory"]
    assert 0 < mem["argument_bytes"] < mem["peak_bytes"]
    assert mem["temp_bytes"] == mem["peak_bytes"] - mem["argument_bytes"]
    assert ops.launches == launches


@pytest.mark.parametrize("arch,ratio", [("deepseek-7b", 1.0790094339622642),
                                        ("olmoe-1b-7b", 1.152471083070452)])
def test_run_cell_remat_dots_recomputes_the_kernels(arch, ratio):
    cells = {}
    for remat in ("full", "dots", "none"):
        cells[remat] = dryrun.run_cell(
            arch, Shape("r_train", 64, 2, "train"),
            overrides=_fields(_cfg(arch, remat=remat)))
    assert cells["dots"]["kernel_calls"] == cells["full"]["kernel_calls"]
    assert cells["none"]["kernel_calls"]["flash_attention"] == 1
    dots = cells["dots"]
    assert dots["cost"]["flops"] / dots["step_cost"]["flops"] == \
        pytest.approx(ratio, rel=1e-6)
    # "dots" keeps the products' outputs: more than "full" holds, less
    # than "none", at two layers: at one, "full"'s recompute of the layer
    # in the backward holds what "none" kept (the fused ops' Functions save
    # only their inputs), and the two peaks are one
    peaks = {}
    for remat in cells:
        cfg = _cfg(arch, remat=remat)
        cfg = cfg.with_(segments=tuple(dataclasses.replace(s, n_layers=2)
                                       for s in cfg.segments))
        peaks[remat] = dryrun.run_cell(
            arch, Shape("r_train", 64, 2, "train"),
            overrides=_fields(cfg))["memory"]["peak_bytes"]
    assert peaks["full"] < peaks["dots"] < peaks["none"]


def test_head_product_on_meta_keeps_no_f32_copy():
    """The bf16 head of the loss on meta (``models.model._HeadProduct``):
    its forward and backward count the FLOPs of the three products that
    the f32 head's did (2 T D V each), and its peak holds no f32 copy of x
    or of the head (T D 4 + D V 4 bytes), only the cotangent rounded to
    bf16 (T V 2): below the f32 head's at tokens = d_model, as in
    training's steps (8192 and 7168 for the deepseek-v3 cut)."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.models.model import _HeadProduct
    T, D, V = 64, 64, 256
    results = {}
    for name, fn in (("bf16", _HeadProduct.apply),
                     ("f32", lambda x, h: x.float() @ h.float())):
        x = torch.empty(T, D, dtype=torch.bfloat16, device=META,
                        requires_grad=True)
        h = torch.empty(D, V, dtype=torch.bfloat16, device=META,
                        requires_grad=True)
        flops = FlopCounterMode(display=False)
        with dryrun.MetaMemory() as mem, flops:
            mem.hold((x, h))
            y = fn(x, h)
            assert y.dtype == torch.float32 and y.shape == (T, V)
            y.backward(torch.empty(T, V, device=META))
        assert x.grad.dtype == h.grad.dtype == torch.bfloat16
        results[name] = (flops.get_total_flops(), mem.peak)
    assert results["bf16"][0] == results["f32"][0] == 3 * 2 * T * D * V
    assert results["bf16"][1] < results["f32"][1]


def test_meta_memory_by_hand():
    a = torch.empty(1000, device=META)                  # 4000 B
    view = a[:10]
    with dryrun.MetaMemory() as mem:
        assert mem.hold({"a": a, "view": view}) == 4000
        b = a * 2                                       # + 4000
        c = b + 1                                       # + 4000: 12000
        del b                                           # 8000
        d = c.view(10, 100).sum()                       # + 4: 8004
        c.add_(1)                                       # in place: 8004
        live = mem.live
    assert (mem.peak, live) == (12000, 8004)
    # bytes read and written: a*2, b+1, sum, add_ (views move nothing)
    assert mem.accessed == 8000 + 8000 + 4004 + 8000
    assert d.is_meta


def test_cli_writes_outside_benchmarks(tmp_path, monkeypatch):
    launches = _forbid_plain(monkeypatch)
    assert dryrun.main(["--arch", "hymba-1.5b", "--shape", "train_4k",
                        "--out", str(tmp_path)]) == 0
    (path,) = tmp_path.glob("*.json")
    r = json.loads(path.read_text())
    assert r["cell"] == "hymba-1.5b__train_4k__gpu1" == path.stem
    assert r["status"] == "ok" and r["leaves"] == 1662161600
    assert r["kernel_calls"]["attention_bwd"] == 32
    assert r["memory"]["peak_bytes"] > 80e9      # does not fit one card
    assert ops.launches == launches
    assert "benchmarks" not in str(dryrun.RESULTS)
    assert dryrun.RESULTS.name == "dryrun_out"


def test_cli_mesh_prices_the_sequence_split(tmp_path, monkeypatch):
    """``--mesh 1x2`` prices smollm-135m's ``dp_seq`` step as rank 0 of
    (1, 2): its block of 2048 of the 4096 positions, the K and V of each
    layer gathered over the sequence (and again in the remat replay), the
    gathers' reduce-scatters in the backward, each leaf's gradient summed
    over 'model'; the attention kernels priced at rank 0's offset (0): its
    live pairs are a quarter of the whole sequence's."""
    import torch.distributed as dist
    launches = _forbid_plain(monkeypatch)
    assert dryrun.main(["--arch", "smollm-135m", "--shape", "train_4k",
                        "--mesh", "1x2", "--out", str(tmp_path)]) == 0
    assert not dist.is_initialized()
    (path,) = tmp_path.glob("*.json")
    r = json.loads(path.read_text())
    assert r["cell"] == "smollm-135m__train_4k__gpu2" == path.stem
    assert r["status"] == "ok" and r["mesh"] == {"data": 1, "model": 2}
    cfg = get_config("smollm-135m")
    L, S, Bn = cfg.n_layers, 4096, 256
    kv = Bn * S * cfg.n_kv_heads * cfg.hd * 2       # a gathered K or V
    c = r["collectives"]
    assert c["counts"]["all-gather"] == 2 * 2 * L     # fwd and replay
    assert c["counts"]["reduce-scatter"] == 2 * L
    assert c["per_kind_bytes"]["all-gather"] == 4 * L * kv
    leaves = 2 + 9 * L
    assert c["counts"]["all-reduce"] == 2 + leaves    # the loss, the grads
    assert r["kernel_calls"] == {"flash_attention": 2 * L,
                                 "attention_bwd": L, "adamw": leaves,
                                 "rmsnorm": 4 * L + 1,
                                 "rmsnorm_bwd": 2 * L + 1,
                                 "rope": 4 * L, "rope_bwd": 2 * L,
                                 "silu_gate": 2 * L, "silu_gate_bwd": L}
    one = dryrun.run_cell("smollm-135m", "train_4k")
    assert r["leaves"] == one["leaves"]               # whole on every rank
    # rank 0's attention: a quarter of the pairs (its 2048 queries against
    # the keys before them), the bound's FLOPs with them
    assert r["kernel_flops"] == pytest.approx(
        one["kernel_flops"] * fa.live_pairs(2048, 4096, True, 0)
        / fa.live_pairs(4096, 4096, True, 0), rel=1e-12)
    assert ops.launches == launches


@pytest.mark.parametrize("flag", ["--multi-pod", "--both-meshes"])
def test_cli_refuses_several_cards(flag, tmp_path):
    """The production meshes, which the dry run once refused, are priced:
    rank 0 of (2, 16, 16), and with ``--both-meshes`` of (16, 16) too,
    over a fake process group that ``main`` ends."""
    import torch.distributed as dist
    assert dryrun.main(["--arch", "smollm-135m", "--shape", "decode_32k",
                        flag, "--out", str(tmp_path)]) == 0
    assert not dist.is_initialized()
    chips = [512] if flag == "--multi-pod" else [256, 512]
    got = sorted(tmp_path.glob("*.json"))
    assert [p.stem for p in got] == [
        f"smollm-135m__decode_32k__gpu{n}" for n in chips]
    for n, path in zip(chips, got):
        r = json.loads(path.read_text())
        assert r["status"] == "ok" and r["chips"] == n
        assert r["mesh"] == ({"data": 16, "model": 16} if n == 256 else
                             {"pod": 2, "data": 16, "model": 16})
        one = dryrun.run_cell("smollm-135m", "decode_32k")
        # dp_seq: the parameters stay whole; the batch is 1 / data ranks
        assert r["leaves"] == one["leaves"]
        assert r["memory"]["peak_bytes"] < one["memory"]["peak_bytes"]
