"""Shared set-up of the tests that read JPEG and TIFF splits
(tests/test_torch_{codecs,dataio,train_data,cli}.py): a BOP split of the
synthetic fixture with its rgb images re-encoded by PIL."""

import os
import os.path as osp

from PIL import Image

# rgb file extension -> how PIL writes it: baseline JPEG (4:2:0, libjpeg's
# default tables at quality 95), or gray LZW TIFF as ITODD's gray images
FORMATS = {
    "jpg": lambda img, path: img.convert("RGB").save(path, "JPEG", quality=95),
    "tif": lambda img, path: img.convert("L").save(path, "TIFF", compression="tiff_lzw"),
}


def reencode_rgb(split_dir: str, ext: str) -> int:
    """Replace every scene's rgb/*.png in `split_dir` by the same image as
    rgb/*.<ext> (see FORMATS); returns the number of images."""
    n = 0
    for scene in sorted(os.listdir(split_dir)):
        rgb_dir = osp.join(split_dir, scene, "rgb")
        if not osp.isdir(rgb_dir):
            continue
        for name in sorted(os.listdir(rgb_dir)):
            if name.endswith(".png"):
                src = osp.join(rgb_dir, name)
                with Image.open(src) as img:
                    FORMATS[ext](img, src[:-3] + ext)
                os.remove(src)
                n += 1
    return n
