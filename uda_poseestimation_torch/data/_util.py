"""Dataset directory helpers (reference lib/datasets/_util.py).

The port's copy of ``uda_poseestimation_tpu/data/_util.py`` with one
deviation: a missing dataset raises ``FileNotFoundError``. The reference and
the JAX package print a message and call ``sys.exit(0)`` from ``download``,
which reports success to the shell and hides the failure. ``download`` also
fetches nothing itself: it extracts an archive that is already in ``root``,
or raises with the URL to fetch it from.
"""

from __future__ import annotations

import os
import shutil
from typing import List


def download(root: str, file_name: str, archive_name: str, url_link: str):
    """Ensure ``root/file_name`` exists, extracting ``root/archive_name`` if
    it is there; raise ``FileNotFoundError`` otherwise."""
    if os.path.exists(os.path.join(root, file_name)):
        return
    archive_path = os.path.join(root, archive_name)
    if not os.path.exists(archive_path):
        raise FileNotFoundError(
            f"dataset directory {file_name} not found under {root}, nor its archive "
            f"{archive_name}; fetch it from {url_link} into {root}")
    print("Extracting {}".format(archive_name))
    shutil.unpack_archive(archive_path, root)


def check_exits(root: str, file_name: str):
    """Raise ``FileNotFoundError`` unless ``file_name`` exists under ``root``."""
    if not os.path.exists(os.path.join(root, file_name)):
        raise FileNotFoundError(f"dataset directory {file_name} not found under {root}")


def read_list_from_file(file_name: str) -> List[str]:
    with open(file_name, "r") as f:
        return [line.strip() for line in f.readlines()]
