"""How far the matmul kernel's fp32 result drifts as K grows (card only).

    python3 tools/matmul_k_drift.py      # from the repository root

For bf16 x bf16 -> fp32 products of (512, K) @ (K, 4096), N(0, 1) rows
against N(0, 0.02) columns (an unembedding's magnitudes), at K from 1024
to 32768, against the same product in fp64: the largest error over max
|fp64| and the mean of error * sign(fp64) over max |fp64| (below zero: the
sum is pulled toward zero), for one launch of the kernel
(``matmul.matmul_cuda``), for ``ops.matmul`` (which runs a K above
``ops.TC_K_BLOCK`` as blocks added in fp32) and for ``torch.matmul`` in
fp32 (TF32 off).  Prints the card's name and power limit first.
"""
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def main() -> int:
    import torch

    from repro_torch.kernels import matmul as mm
    from repro_torch.kernels import ops

    if not torch.cuda.is_available():
        print("matmul_k_drift: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for k in (1024, 2048, 4096, 5120, 8192, 16384, 32768):
        a = torch.randn((512, k), generator=gen, device="cuda").to(
            torch.bfloat16)
        b = (torch.randn((k, 4096), generator=gen, device="cuda")
             * 0.02).to(torch.bfloat16)
        exact = a.double() @ b.double()
        top = exact.abs().max().item()
        rows = []
        for name, out in (
                ("kernel", mm.matmul_cuda(a, b, out_dtype=torch.float32)),
                ("ops.matmul", ops.matmul(a, b, out_dtype=torch.float32)),
                ("torch.matmul fp32", a.float() @ b.float())):
            err = out.double() - exact
            rows.append(f"{name} max {err.abs().max().item() / top:.3e} "
                        f"bias {(err * exact.sign()).mean().item() / top:+.3e}")
        print(f"K {k}: " + "; ".join(rows), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
