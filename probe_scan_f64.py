"""How far two f32 evaluations of the Mamba scan can sit apart: the scan
kernel (``kernels.ops.mamba_scan``) and its f32 plain version
(``kernels.ref.mamba_scan_ref``), each against the same recurrence run in
f64, at falcon-mamba-7b's width (4, 2048, 8192, 16) and hymba-1.5b's
(4, 2048, 3200, 16), on the inputs of ``tests/test_torch_cuda.py``
(``_scan_inputs``: "large" dt = softplus(normal) x 4 with A = -(1 .. N),
and "small" dt).  Prints, per case, each one's largest absolute error and
how many elements lie past 1e-5 + 1e-5 |y|, the card tests' bound.

One card (about a minute):

    python3 probe_scan_f64.py
"""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tests"))


def f64_scan(u, dt, A, Bc, Cc, D):
    """The scan's recurrence, ``h <- exp(dt A) h + (dt u) B`` and ``y = h.C
    + D u``, in f64."""
    import torch
    B, S, di = u.shape
    h = torch.zeros((B, di, A.shape[1]), dtype=torch.float64,
                    device=u.device)
    u64, dt64, A64 = u.double(), dt.double(), A.double()
    B64, C64 = Bc.double(), Cc.double()
    ys = []
    for t in range(S):
        h = torch.exp(dt64[:, t, :, None] * A64) * h \
            + (dt64[:, t] * u64[:, t])[..., None] * B64[:, t, None]
        ys.append(torch.einsum("bdn,bn->bd", h, C64[:, t]))
    return torch.stack(ys, 1) + u64 * D.double()


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("probe_scan_f64: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import ops, ref
    import test_torch_cuda as tc
    dev = torch.device("cuda")
    for kind in ("large", "small"):
        for (B, S, di, N) in ((4, 2048, 8192, 16), (4, 2048, 3200, 16)):
            u, dt, A, Bc, Cc, D = tc._scan_inputs(B, S, di, N, torch.float32,
                                                  dev, S + di, kind)
            y, _ = ops.mamba_scan(u, dt, A, Bc, Cc, D)
            y32, _ = ref.mamba_scan_ref(u, dt, A, Bc, Cc, D)
            y64 = f64_scan(u, dt, A, Bc, Cc, D)
            for name, got in (("kernel", y), ("plain f32", y32)):
                d = (got.double() - y64).abs()
                bad = int((d > 1e-5 + 1e-5 * y64.abs()).sum())
                print(f"{kind} {(B, S, di, N)} {name} vs f64: max abs "
                      f"{float(d.max()):.3g}, max |y| "
                      f"{float(y64.abs().max()):.3g}, past 1e-5 {bad}",
                      flush=True)
            del y64
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
