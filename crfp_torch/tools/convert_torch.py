"""Convert a reference PyTorch checkpoint to the flat flax ``.npz`` both
packages load (the name map is ``crfp_torch.params.convert_state_dict``).

    python -m crfp_torch.tools.convert_torch ckpt.pt out.npz [--lenient]

The JAX package's CLI (crfp_tpu/tools/convert_torch.py) writes orbax, which
needs JAX; ``params.save_npz`` writes the format both read.
"""

from __future__ import annotations

import argparse

from crfp_torch.params import load_torch_checkpoint, save_npz


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="convert a reference .pt/.pth checkpoint "
                                "to the flat flax .npz both packages load")
    p.add_argument("ckpt")
    p.add_argument("out")
    p.add_argument("--lenient", action="store_true",
                   help="skip unmapped keys instead of failing")
    args = p.parse_args(argv)
    sd = load_torch_checkpoint(args.ckpt, strict=not args.lenient)
    save_npz(sd, args.out)
    n = sum(v.numel() for v in sd.values())
    print(f"converted {args.ckpt} -> {args.out} ({n:,} parameters)")


if __name__ == "__main__":
    main()
