"""Serving launcher: batched prefill + decode with the KV cache
(GQA / MLA-absorbed / SSM-state / rolling-SWA per arch).  The loop itself
lives in ``repro_torch.launch.driver``.  A port of ``repro.launch.serve``
with ``--device`` (the card unless ``cpu`` is asked for):

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-7b \
        --smoke --device cpu [--batch 4 --prompt-len 32 --new-tokens 16]
        [--kv-int8]
"""
import argparse
import dataclasses

from repro_torch.configs.base import get_config, list_archs, smoke_config
from repro_torch.launch.driver import serve_greedy


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list_archs())
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--kv-int8", action="store_true",
                    help="exponent-aligned int8 KV cache (halves cache reads)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without a card)")
    args = ap.parse_args(argv)

    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if cfg.encoder_only:
        raise SystemExit(f"{args.arch} is encoder-only: no decode step")
    if args.kv_int8 and cfg.mla is None and cfg.ssm is None:
        cfg = dataclasses.replace(cfg, kv_cache_int8_scale=8.0)
    res = serve_greedy(cfg, args.batch, args.prompt_len, args.new_tokens,
                       device=args.device)

    print(f"{cfg.name}: prefill {res.prefill_s:.3f} s, "
          f"{args.new_tokens - 1} decode steps, "
          f"{res.ms_per_token:.1f} ms/token on {res.tokens.device}")
    print(res.tokens)


if __name__ == "__main__":
    main()
