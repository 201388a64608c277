"""Filesystem helpers: a working-directory context, a space-free copy of a
path, run-directory increments, file age, date and size, the latest run's
checkpoint, and a re-save of checkpoints for deployment.

Port of ``xlstm_yolo_tpu/utils/files.py``. The JAX package's checkpoints
are directories (``last.ckpt/meta.yaml``); the port's are one ``.pt`` file
(``utils.checkpoint``), so ``get_latest_run`` looks for ``last*.pt`` and
``update_models`` re-saves ``.pt`` files with their EMA weights and without
optimizer state.
"""
from __future__ import annotations

import contextlib
import glob
import os
import shutil
import tempfile
from datetime import datetime
from pathlib import Path

from . import LOGGER, increment_path

__all__ = ("WorkingDirectory", "spaces_in_path", "increment_path", "file_age", "file_date",
           "file_size", "get_latest_run", "update_models")


class WorkingDirectory(contextlib.ContextDecorator):
    """Change into ``new_dir`` for a ``with`` block or a decorated call."""

    def __init__(self, new_dir: str | Path):
        self.dir = new_dir
        self.cwd = Path.cwd().resolve()

    def __enter__(self):
        os.chdir(self.dir)
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        os.chdir(self.cwd)


@contextlib.contextmanager
def spaces_in_path(path: str | Path):
    """Yield ``path`` itself when it has no space; else a copy of it in a
    temporary directory under a name without spaces, copied back on exit."""
    if " " not in str(path):
        yield path
        return
    string = isinstance(path, str)
    path = Path(path)
    with tempfile.TemporaryDirectory() as tmp:
        tmp_path = Path(tmp) / path.name.replace(" ", "_")
        if path.is_dir():
            shutil.copytree(path, tmp_path)
        elif path.is_file():
            tmp_path.parent.mkdir(parents=True, exist_ok=True)
            shutil.copy2(path, tmp_path)
        try:
            yield str(tmp_path) if string else tmp_path
        finally:
            if tmp_path.is_dir():
                shutil.copytree(tmp_path, path, dirs_exist_ok=True)
            elif tmp_path.is_file():
                shutil.copy2(tmp_path, path)


def file_age(path: str | Path = __file__) -> int:
    """Days since the last modification."""
    return (datetime.now() - datetime.fromtimestamp(Path(path).stat().st_mtime)).days


def file_date(path: str | Path = __file__) -> str:
    """The modification date as 'YYYY-M-D'."""
    t = datetime.fromtimestamp(Path(path).stat().st_mtime)
    return f"{t.year}-{t.month}-{t.day}"


def file_size(path: str | Path) -> float:
    """A file's or a directory tree's size in MB; 0 for neither."""
    path = Path(path)
    mb = 1 << 20
    if path.is_file():
        return path.stat().st_size / mb
    if path.is_dir():
        return sum(f.stat().st_size for f in path.glob("**/*") if f.is_file()) / mb
    return 0.0


def get_latest_run(search_dir: str = ".") -> str:
    """The newest ``last*.pt`` under ``search_dir`` (for ``resume``), or ''."""
    last_list = glob.glob(f"{search_dir}/**/last*.pt", recursive=True)
    return max(last_list, key=os.path.getctime) if last_list else ""


def update_models(model_names=("yolov8n.pt",), source_dir: Path = Path("."),
                  update_names: bool = False):
    """Re-save each checkpoint of ``model_names`` under
    ``source_dir/updated_models`` with its EMA weights and without optimizer
    state; a missing one is skipped with a warning. The class names travel
    in the checkpoint, so ``update_names`` has nothing to add."""
    from .checkpoint import load_checkpoint, save_checkpoint

    target_dir = Path(source_dir) / "updated_models"
    target_dir.mkdir(parents=True, exist_ok=True)
    for name in model_names:
        src = Path(source_dir) / name
        if not src.is_file():
            LOGGER.warning(f"update_models: {src} not found, skipping")
            continue
        model, meta = load_checkpoint(src, use_ema=True, device="cpu")
        dst = target_dir / name
        save_checkpoint(dst, model, epoch=-1, best_fitness=meta.get("best_fitness", 0.0))
        LOGGER.info(f"update_models: re-saved {src} -> {dst}")
