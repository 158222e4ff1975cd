#!/usr/bin/env python
"""Build .rec/.idx packs from an image directory or list file (the
port's counterpart of the reference's ``tools/im2rec.py``, with its
CLI; ref: tools/im2rec.py, the list generation and record packing).

    python -m mxnet_tpu_torch.tools.im2rec PREFIX ROOT [--list]
        [--resize N] [--center-crop N] [--quality Q]
        [--pass-through-raw] [--shuffle] [--seed S]

Without ``PREFIX.lst`` it first writes one from ``ROOT`` (each class a
sub-folder, labels by sorted folder name). Images are packed as JPEG at
``--quality`` (95 by default) or stored raw, RGB at their size after
``--resize``/``--center-crop`` (``--pass-through-raw``): the native
pipeline takes a raw record whose size is the target's as it is.

List file format (reference-compatible): index\tlabel[\tlabel...]\tpath
"""
from __future__ import annotations

import argparse
import os
import random
import sys


def make_list(args):
    exts = (".jpg", ".jpeg", ".png")
    items = []
    classes = sorted(
        d for d in os.listdir(args.root)
        if os.path.isdir(os.path.join(args.root, d)))
    if classes:
        for li, cls in enumerate(classes):
            for f in sorted(os.listdir(os.path.join(args.root, cls))):
                if f.lower().endswith(exts):
                    items.append((float(li), os.path.join(cls, f)))
    else:
        for f in sorted(os.listdir(args.root)):
            if f.lower().endswith(exts):
                items.append((0.0, f))
    if args.shuffle:
        random.Random(args.seed).shuffle(items)
    with open(args.prefix + ".lst", "w") as out:
        for i, (label, path) in enumerate(items):
            out.write("%d\t%g\t%s\n" % (i, label, path))
    print("wrote %d entries to %s.lst" % (len(items), args.prefix))


def im2rec(args):
    import cv2
    import numpy as np
    from mxnet_tpu_torch import recordio

    lst = args.prefix + ".lst"
    if not os.path.exists(lst):
        make_list(args)
    rec = recordio.MXIndexedRecordIO(args.prefix + ".idx",
                                     args.prefix + ".rec", "w")
    n = 0
    with open(lst) as f:
        for line in f:
            parts = line.strip().split("\t")
            if len(parts) < 3:
                continue
            idx = int(parts[0])
            labels = [float(x) for x in parts[1:-1]]
            path = os.path.join(args.root, parts[-1])
            img = cv2.imread(path, cv2.IMREAD_COLOR)
            if img is None:
                print("skip unreadable %s" % path, file=sys.stderr)
                continue
            if args.resize:
                h, w = img.shape[:2]
                if min(h, w) != args.resize:
                    s = args.resize / min(h, w)
                    img = cv2.resize(img, (int(w * s + 0.5), int(h * s + 0.5)),
                                     interpolation=cv2.INTER_AREA)
            label = labels[0] if len(labels) == 1 else np.array(labels)
            header = recordio.IRHeader(0, label, idx, 0)
            if args.pass_through_raw:
                if args.center_crop:
                    h, w = img.shape[:2]
                    c = args.center_crop
                    y0, x0 = (h - c) // 2, (w - c) // 2
                    img = img[y0:y0 + c, x0:x0 + c]
                rgb = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
                rec.write_idx(idx, recordio.pack(header,
                                                 np.ascontiguousarray(rgb).tobytes()))
            else:
                rec.write_idx(idx, recordio.pack_img(header, img,
                                                     quality=args.quality))
            n += 1
    rec.close()
    print("packed %d records into %s.rec" % (n, args.prefix))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("prefix", help="output prefix for .lst/.rec/.idx")
    ap.add_argument("root", help="image root directory")
    ap.add_argument("--list", action="store_true",
                    help="only generate the .lst file")
    ap.add_argument("--resize", type=int, default=0,
                    help="resize shorter side before packing")
    ap.add_argument("--center-crop", type=int, default=0,
                    help="(raw mode) center-crop to this square size")
    ap.add_argument("--quality", type=int, default=95)
    ap.add_argument("--pass-through-raw", action="store_true",
                    help="store raw RGB pixels instead of JPEG")
    ap.add_argument("--shuffle", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.list:
        make_list(args)
    else:
        im2rec(args)


if __name__ == "__main__":
    main()
