"""Pack an image directory into the pre-decoded flat store training reads:

    python -m situation_recognition_tpu_torch.tools.pack_dataset \\
        IMG_DIR OUT_DIR [--annotations train.json dev.json ...]

The face of ``data/dataset.write_packed``: ``OUT_DIR/images.bin`` (every
image decoded once and normalised to short side 256 as the live loader
does it) and ``OUT_DIR/index.json`` ({name: [offset, h, w]}), the JAX
package's ``tools/pack_dataset.py`` store byte for byte.  With
``--annotations`` only the images those JSON files name are packed (in
their order, each once); otherwise the whole directory, sorted.  Train on
it with the CLI's ``--packed_dir OUT_DIR``.  Prints one JSON line:
``packed``, ``bytes``, ``seconds``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def image_names(img_dir: str, annotations) -> list:
    """The names to pack: those of the annotation files in order, each
    once, or the directory's sorted."""
    if not annotations:
        return sorted(os.listdir(img_dir))
    names, seen = [], set()
    for path in annotations:
        with open(path) as f:
            for name in json.load(f):
                if name not in seen:
                    seen.add(name)
                    names.append(name)
    return names


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("img_dir")
    ap.add_argument("out_dir")
    ap.add_argument("--annotations", nargs="*", default=[],
                    help="JSON annotation files; pack only their image keys")
    args = ap.parse_args(argv)

    from situation_recognition_tpu_torch.data.dataset import (
        _decode_image, write_packed)

    names = image_names(args.img_dir, args.annotations)
    t0 = time.perf_counter()

    def images():
        for i, name in enumerate(names):
            yield name, _decode_image(os.path.join(args.img_dir, name))
            if (i + 1) % 5000 == 0:
                rate = (i + 1) / (time.perf_counter() - t0)
                print(f"[pack] {i + 1}/{len(names)} ({rate:.0f} img/s)",
                      file=sys.stderr)

    count = write_packed(args.out_dir, images())
    size = os.path.getsize(os.path.join(args.out_dir, "images.bin"))
    print(json.dumps({"packed": count, "bytes": size,
                      "seconds": round(time.perf_counter() - t0, 1)}))


if __name__ == "__main__":
    main()
