"""Training launcher.  A port of ``repro.launch.train`` with ``--device``
(the card unless ``cpu`` is asked for):

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-7b \
        --smoke --device cpu [--steps 30 --batch 4 --seq 64]
        [--grad-compress-planes 8] [--ckpt-dir DIR --ckpt-every 10]

``--smoke`` uses the reduced config; without it the full config is built
(on one card only the small archs fit).  The parameters are drawn from
seed 0 on the device.  MoE archs take the reference's ``shard_map``
dispatch setting, which on one device is the capacity dispatch, as in the
reference.  A run resumes from the newest checkpoint in ``--ckpt-dir``.
"""
import argparse
import dataclasses
import os
import tempfile

from repro_torch.configs.base import get_config, list_archs, smoke_config
from repro_torch.models.model import Model, count_params
from repro_torch.optim import adamw
from repro_torch.train.loop import Trainer, TrainerConfig, synthetic_data


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list_archs())
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_train"))
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--grad-compress-planes", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without a card)")
    args = ap.parse_args(argv)

    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if cfg.moe is not None:
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, dispatch="shard_map"))
    model = Model(cfg, device=args.device)
    print(f"{cfg.name}: {count_params(cfg) / 1e6:.1f}M params")
    trainer = Trainer(
        model,
        adamw.AdamWConfig(lr=3e-4, warmup_steps=max(args.steps // 10, 1),
                          total_steps=args.steps),
        TrainerConfig(total_steps=args.steps, ckpt_every=args.ckpt_every,
                      ckpt_dir=args.ckpt_dir, log_every=5,
                      grad_compress_planes=args.grad_compress_planes),
        synthetic_data(cfg, args.batch, args.seq, device=args.device))
    res = trainer.run()
    for m in res["metrics"]:
        print(f"step {m['step']:5d}  loss {m['loss']:.4f}  "
              f"{m['dt'] * 1e3:8.1f} ms")
    return res


if __name__ == "__main__":
    main()
