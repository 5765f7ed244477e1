"""Git sparse-checkout wrapper for partial corpus downloads.

A copy of ``codec_eval_tpu/corpus/sparse.py`` (reference:
src/corpus/sparse.rs:35-424): blob-filtered sparse clones, the filter
vocabulary (pattern / directory / format / category / min-size / paths)
and pattern management, through the ``git`` command.
"""

from __future__ import annotations

import fnmatch
import subprocess
from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional, Sequence

from ..errors import CorpusError


def _run_git(cwd: Path, args: Sequence[str]) -> str:
    try:
        result = subprocess.run(
            ["git", *args],
            cwd=str(cwd),
            capture_output=True,
            text=True,
            check=False,
        )
    except FileNotFoundError as e:
        raise CorpusError("git CLI not found") from e
    if result.returncode != 0:
        raise CorpusError(
            f"git {' '.join(args)} failed: {result.stderr.strip()}"
        )
    return result.stdout


@dataclass
class SparseFilter:
    """Filter kinds -> sparse-checkout patterns.
    reference: src/corpus/sparse.rs:44-87."""

    kind: str  # pattern | directory | format | category | min_size | paths
    value: object = None

    @classmethod
    def pattern(cls, p: str) -> "SparseFilter":
        return cls("pattern", p)

    @classmethod
    def directory(cls, d: str) -> "SparseFilter":
        return cls("directory", d)

    @classmethod
    def format(cls, ext: str) -> "SparseFilter":
        return cls("format", ext)

    @classmethod
    def category(cls, cat: str) -> "SparseFilter":
        return cls("category", cat)

    @classmethod
    def min_size(cls, width: int, height: int) -> "SparseFilter":
        return cls("min_size", (width, height))

    @classmethod
    def paths(cls, paths: List[str]) -> "SparseFilter":
        return cls("paths", list(paths))

    def to_patterns(self) -> List[str]:
        if self.kind == "pattern":
            return [str(self.value)]
        if self.kind == "directory":
            d = str(self.value).rstrip("/")
            return [f"{d}/", f"{d}/**"]
        if self.kind == "format":
            ext = str(self.value).lstrip(".")
            return [f"**/*.{ext}"]
        if self.kind == "category":
            cat = self.value
            return [f"**/{cat}/", f"**/{cat}/**", f"{cat}/", f"{cat}/**"]
        if self.kind == "min_size":
            # Requires manifest lookup; select everything, filter later.
            return ["**/*"]
        if self.kind == "paths":
            return list(self.value)
        raise ValueError(f"unknown filter kind {self.kind}")


@dataclass
class SparseStatus:
    enabled: bool
    patterns: List[str]
    checked_out_files: int
    total_files: Optional[int]

    def percentage(self) -> Optional[float]:
        """Checked-out files as a percentage of the total (None when the
        total is unknown).  reference: src/corpus/sparse.rs:317-325."""
        if self.total_files is None:
            return None
        if self.total_files == 0:
            return 100.0
        return (self.checked_out_files / self.total_files) * 100.0


class SparseCheckout:
    """Manage a blob-filtered sparse git checkout.
    reference: src/corpus/sparse.rs:91-298."""

    def __init__(self, repo_path: Path, remote_url: Optional[str] = None):
        self.repo_path = Path(repo_path)
        self.remote_url = remote_url

    # -- constructors ------------------------------------------------------
    @classmethod
    def init(cls, repo_path) -> "SparseCheckout":
        repo_path = Path(repo_path)
        _run_git(repo_path, ["sparse-checkout", "init", "--cone"])
        return cls(repo_path)

    @classmethod
    def clone(cls, url: str, target) -> "SparseCheckout":
        target = Path(target)
        target.parent.mkdir(parents=True, exist_ok=True)
        _run_git(
            target.parent,
            [
                "clone", "--filter=blob:none", "--sparse", "--no-checkout",
                url, target.name,
            ],
        )
        _run_git(target, ["sparse-checkout", "init", "--cone"])
        return cls(target, url)

    @classmethod
    def clone_shallow(cls, url: str, target, depth: int) -> "SparseCheckout":
        target = Path(target)
        target.parent.mkdir(parents=True, exist_ok=True)
        _run_git(
            target.parent,
            [
                "clone", "--filter=blob:none", "--sparse", "--no-checkout",
                "--depth", str(depth), url, target.name,
            ],
        )
        _run_git(target, ["sparse-checkout", "init", "--cone"])
        return cls(target, url)

    @classmethod
    def open(cls, repo_path) -> "SparseCheckout":
        repo_path = Path(repo_path)
        if not (repo_path / ".git").exists():
            raise CorpusError(f"Not a git repository: {repo_path}")
        try:
            remote = _run_git(repo_path, ["remote", "get-url", "origin"]).strip()
        except CorpusError:
            remote = None
        return cls(repo_path, remote)

    # -- pattern management ------------------------------------------------
    def add_paths(self, paths: Sequence[str]) -> None:
        _run_git(self.repo_path, ["sparse-checkout", "add", *paths])
        self._materialize_if_unborn()

    def set_paths(self, paths: Sequence[str]) -> None:
        _run_git(self.repo_path, ["sparse-checkout", "set", *paths])
        self._materialize_if_unborn()

    def _materialize_if_unborn(self) -> None:
        """After a ``--no-checkout`` sparse clone the index is empty, so
        ``sparse-checkout set`` alone materializes nothing; run the first
        checkout once patterns exist (reference clones then check out:
        src/corpus/sparse.rs:91-182)."""
        if _run_git(self.repo_path, ["ls-files"]).strip():
            return
        try:
            _run_git(self.repo_path, ["rev-parse", "--verify", "HEAD"])
        except CorpusError:
            return  # unborn branch: nothing to check out yet
        self.checkout()

    def add_filter(self, filter_: SparseFilter) -> None:
        self.add_paths(filter_.to_patterns())

    def set_filters(self, filters: Sequence[SparseFilter]) -> None:
        patterns = [p for f in filters for p in f.to_patterns()]
        self.set_paths(patterns)

    def list_patterns(self) -> List[str]:
        out = _run_git(self.repo_path, ["sparse-checkout", "list"])
        return [line for line in out.splitlines() if line]

    # -- operations --------------------------------------------------------
    def checkout(self, ref: Optional[str] = None) -> None:
        args = ["checkout"] if ref is None else ["checkout", ref]
        _run_git(self.repo_path, args)

    def checkout_ref(self, reference: str) -> None:
        """Check out a specific branch/tag/commit.
        reference: src/corpus/sparse.rs:239-242."""
        self.checkout(reference)

    def fetch(self) -> None:
        _run_git(self.repo_path, ["fetch", "--filter=blob:none"])

    def pull(self) -> None:
        self.fetch()
        _run_git(self.repo_path, ["pull"])

    def disable(self) -> None:
        _run_git(self.repo_path, ["sparse-checkout", "disable"])

    def reapply(self) -> None:
        _run_git(self.repo_path, ["sparse-checkout", "reapply"])

    def status(self) -> SparseStatus:
        try:
            config = _run_git(self.repo_path, ["config", "core.sparseCheckout"])
        except CorpusError:
            config = ""
        enabled = config.strip() == "true"
        patterns = self.list_patterns() if enabled else []
        # `ls-files -t` distinguishes materialized entries (H) from
        # skip-worktree ones (S); plain `ls-files` counts both.
        files = _run_git(self.repo_path, ["ls-files", "-t"])
        checked_out = sum(
            1 for line in files.splitlines() if line.startswith("H ")
        )
        try:
            tree = _run_git(self.repo_path, ["ls-tree", "-r", "--name-only", "HEAD"])
            total = len(tree.splitlines())
        except CorpusError:
            total = None
        return SparseStatus(enabled, patterns, checked_out, total)

    # -- preview -----------------------------------------------------------
    def preview_patterns(
        self, patterns: Sequence[str], all_files: Optional[Sequence[str]] = None
    ) -> List[str]:
        """Which repo files would the patterns select.
        reference: src/corpus/sparse.rs:369-424."""
        if all_files is None:
            tree = _run_git(self.repo_path, ["ls-tree", "-r", "--name-only", "HEAD"])
            all_files = tree.splitlines()
        return [
            f for f in all_files if any(matches_pattern(f, p) for p in patterns)
        ]


def matches_pattern(path: str, pattern: str) -> bool:
    """Sparse-checkout-style glob matching (`**` crosses directories,
    trailing `/` selects subtrees).  reference: src/corpus/sparse.rs:388-424."""
    if pattern.endswith("/"):
        return path.startswith(pattern) or path.startswith(pattern.rstrip("/") + "/")
    if "**" in pattern:
        # Translate ** to match across separators; * stays within a segment.
        import re

        regex = ""
        i = 0
        while i < len(pattern):
            c = pattern[i]
            if pattern[i : i + 2] == "**":
                regex += ".*"
                i += 2
                if i < len(pattern) and pattern[i] == "/":
                    i += 1
            elif c == "*":
                regex += "[^/]*"
                i += 1
            elif c == "?":
                regex += "[^/]"
                i += 1
            else:
                regex += re.escape(c)
                i += 1
        return re.fullmatch(regex, path) is not None
    return fnmatch.fnmatch(path, pattern)
