"""Time K5 (``sorted_window_accumulate``) of one checkout on one GPU.

    python apnerf_torch/kernels/time_scatter.py [--root DIR] [--label NAME]

Run as a file, not as a module: ``--root`` (default: this checkout) names
the checkout whose ``apnerf_torch`` and ``chip_smoke.py`` are imported, so
that two trees can be timed in turns within one process tree on one card
(two calls may land on two cards):

    git archive <parent> | tar -x -C _checkout/parent
    for root in _checkout/parent . . _checkout/parent; do
        python apnerf_torch/kernels/time_scatter.py --root $root; done

At the three stage-1 shapes of ``chip_smoke.py`` (``scatter_inputs``: 2^20
rows of 96 channels into 162^3, 82^3 and 42^3 cells, transposed) it prints,
three times each, the CUDA-event median of 7 single calls (the wrapper's
host work included) and the time of a call when 10 are queued back to back
(the device's time).
"""
import argparse
import sys
from pathlib import Path


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--root", default=str(Path(__file__).resolve().parents[2]))
    p.add_argument("--label", default="")
    args = p.parse_args(argv)
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("time_scatter: needs a CUDA device")
    import chip_smoke as cs
    from apnerf_torch.kernels import scatter as sc
    label = args.label or args.root
    print(f"time_scatter {label}: {cs.nvidia_smi_line()}", flush=True)
    for n_pad in (161, 81, 41):
        idx, upd, n_rows = cs.scatter_inputs(torch, n_pad)

        def call():
            return sc.sorted_window_accumulate(idx, upd, n_rows,
                                               transposed=True)
        single = [cs.cuda_ms(call)[0] for _ in range(3)]
        queued = [cs.queued_ms(call, launches=10) for _ in range(3)]
        print(f"time_scatter {label}: n_rows={n_rows}: single call "
              f"{[round(t, 4) for t in single]} ms, 10 queued "
              f"{[round(t, 4) for t in queued]} ms a call", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
