"""End-to-end training driver: data pipeline -> train step ->
checkpoint/restart -> straggler monitoring, with a simulated mid-run
failure and automatic recovery.

    PYTHONPATH=src python -m repro_torch.launch.train_lm --steps 120
    PYTHONPATH=src python -m repro_torch.launch.train_lm --arch mamba2-370m --steps 50
    PYTHONPATH=src python -m repro_torch.launch.train_lm --device cpu --steps 20

The default is a small model (the architecture's reduced config) on the
card; ``--full-width`` gives the ~100M-parameter variant, ``--device cpu``
the CPU.
"""
import argparse
import dataclasses
import tempfile

from repro_torch.configs import get_reduced_config
from repro_torch.data import SyntheticLM
from repro_torch.launch.steps import make_train_step
from repro_torch.models import build_model
from repro_torch.optim import AdamW, warmup_cosine
from repro_torch.runtime import TrainRunner


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="minitron-4b")
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--fail-at", type=int, default=None,
                    help="inject a node failure at this step")
    ap.add_argument("--full-width", action="store_true",
                    help="~100M-parameter config")
    ap.add_argument("--device", default="cuda",
                    help="where to train (default: the card)")
    args = ap.parse_args(argv)

    cfg = get_reduced_config(args.arch)
    if args.full_width:
        cfg = dataclasses.replace(
            cfg, num_layers=12, d_model=768, num_heads=12, num_kv_heads=4,
            head_dim=64, d_ff=3072, vocab_size=32_768, max_seq_len=2048)
    print(f"arch={cfg.name} params≈{cfg.param_count()/1e6:.1f}M device={args.device}")

    model = build_model(cfg, device=args.device)
    opt = AdamW(lr=warmup_cosine(3e-4, 20, args.steps))
    opt_state = opt.init(model.params)
    step_fn = make_train_step(model, opt)
    ds = SyntheticLM(cfg.vocab_size, args.seq, args.batch, seed=0, device=args.device)

    with tempfile.TemporaryDirectory(prefix="repro_torch_ckpt_") as ckpt_dir:
        runner = TrainRunner(step_fn=step_fn, params=model.params, opt_state=opt_state,
                             dataset=ds, ckpt_dir=ckpt_dir, ckpt_every=20,
                             mitigation_hook=lambda rep: print(
                                 f"  [straggler] step {rep.step}: "
                                 f"{rep.slowdown:.1f}x slower"))
        fail_at = args.fail_at if args.fail_at is not None else args.steps // 2
        try:
            out = runner.run(args.steps, fail_at=fail_at)
        except RuntimeError as e:
            print(f"!! {e} — recovering from {ckpt_dir}")
            out = runner.recover_and_run(args.steps)

    print(f"done: steps={out['steps']} final_loss={out['final_loss']:.4f} "
          f"restarts={out['restarts']} stragglers={out['stragglers']}")
    ls = runner.losses
    print(f"loss: first5={sum(ls[:5])/5:.4f} last5={sum(ls[-5:])/5:.4f}")


if __name__ == "__main__":
    main()
