"""File dialog models — FileOpen / FileSaveAs equivalents.

The reference implements two ImGui modal directory browsers
(file-open.cpp:6-99, file-save-as.cpp:6-101): chdir-based navigation, a
hidden-file filter, directories listed first, double-click to descend or
accept, and (for Save As) an editable filename field seeded by clicking an
entry.  These are the headless models of the same behavior; any front end
(the web shell, tests, a future SDL shell) renders ``entries()`` and calls
``activate``/``accept``.  Counterpart of ``melonix_tpu/ui/dialogs.py``
(host code only; the same behaviour).
"""

from __future__ import annotations

import os
from typing import Optional


class FileOpenDialog:
    """Directory browser returning an existing file path.

    Mirrors FileOpen: entries are '..' + directories + files of the current
    directory, hidden names filtered (file-open.cpp:30-38), directories
    first, each group sorted by name; activating a directory descends
    (chdir semantics, file-open.cpp:62-71), activating a file selects it
    and ``accept`` returns its absolute path.
    """

    def __init__(self, cwd: str | None = None):
        self.cwd = os.path.abspath(cwd or os.getcwd())
        self.selected: Optional[str] = None
        self.done = False  # accepted or cancelled

    def entries(self) -> list[tuple[str, bool]]:
        """[(name, is_dir)] — '..' first, then dirs, then files, sorted."""
        dirs, files = [], []
        try:
            for name in os.listdir(self.cwd):
                if name.startswith("."):
                    continue  # hidden filter (file-open.cpp:33)
                full = os.path.join(self.cwd, name)
                (dirs if os.path.isdir(full) else files).append(name)
        except OSError:
            pass
        out = [("..", True)]
        out += [(d, True) for d in sorted(dirs)]
        out += [(f, False) for f in sorted(files)]
        return out

    def activate(self, name: str) -> Optional[str]:
        """Double-click semantics: descend into directories, accept files.

        Returns the accepted absolute path, or None if still browsing.
        """
        full = os.path.normpath(os.path.join(self.cwd, name))
        if os.path.isdir(full):
            self.cwd = full
            self.selected = None
            return None
        if os.path.isfile(full):
            self.selected = full
            return self.accept()
        return None

    def select(self, name: str) -> None:
        """Single-click: remember the highlighted file."""
        full = os.path.join(self.cwd, name)
        if os.path.isfile(full):
            self.selected = full

    def accept(self) -> Optional[str]:
        if self.selected and os.path.isfile(self.selected):
            self.done = True
            return self.selected
        return None

    def cancel(self) -> None:
        self.done = True
        self.selected = None


class FileSaveAsDialog(FileOpenDialog):
    """FileOpen + an editable filename field (file-save-as.cpp:74-88).

    Clicking an existing file seeds the filename; ``accept`` joins the
    current directory with the typed name (which need not exist yet).
    Used by both "Save As" and "Export WAV" (app.hpp:37-38).
    """

    def __init__(self, cwd: str | None = None, filename: str = ""):
        super().__init__(cwd)
        self.filename = filename

    def select(self, name: str) -> None:
        super().select(name)
        full = os.path.join(self.cwd, name)
        if os.path.isfile(full):
            self.filename = name

    def activate(self, name: str) -> Optional[str]:
        full = os.path.normpath(os.path.join(self.cwd, name))
        if os.path.isdir(full):
            self.cwd = full
            return None
        self.filename = name
        return self.accept()

    def accept(self) -> Optional[str]:
        if not self.filename:
            return None
        self.done = True
        self.selected = os.path.join(self.cwd, self.filename)
        return self.selected
