"""CLI: a fake checkpoint packed without quantizing again (the fake
checkpoint carries its quantizer states).  Counterpart of
``qeft_tpu/convert.py``::

    python -m qeft_tpu_torch.convert ckpt/model_fake ckpt/model_packed [--fuse_stages]

Runs on the GPU unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("src", help="fake checkpoint")
    parser.add_argument("dst", help="packed checkpoint to write")
    parser.add_argument("--fuse_stages", action="store_true",
                        help="pack q/k/v -> qkv and up/gate -> upgate")
    parser.add_argument("--device", default=None, help="default: cuda (required)")
    args = parser.parse_args(argv)

    from qeft_tpu_torch.checkpoint import load_fake, save_packed
    from qeft_tpu_torch.models.registry import get_model_meta
    from qeft_tpu_torch.pipeline import pack_model

    params, states, cfg, family = load_fake(args.src, device=args.device)
    packed = pack_model(params, states, cfg, get_model_meta(family),
                        fuse_stages=args.fuse_stages)
    save_packed(args.dst, packed, cfg, family=family)
    print(f"packed ckpt -> {args.dst}.npz")


if __name__ == "__main__":
    main()
