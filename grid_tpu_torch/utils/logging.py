"""Console logging (twin of ``grid_tpu/utils/logging.py``).

Every function works with ``console=None`` (plain ``print``), so library
use never needs ``rich``; where ``rich`` is missing :func:`make_console`
returns None and the CLI prints plainly.
"""

from __future__ import annotations

from contextlib import contextmanager

THEME = {
    "info": "cyan",
    "success": "bold green",
    "warning": "yellow",
    "danger": "bold red",
    "highlight": "magenta",
}


def make_console():
    """Build the themed console used by the CLI (ref: grid/cli.py:14-30),
    or None without ``rich``."""
    try:
        from rich.console import Console
        from rich.theme import Theme
    except ImportError:
        return None
    return Console(theme=Theme(THEME))


def log(console, msg, style=None):
    """Log a message to the rich console, or print if console is None
    (ref: grid/utils/utils.py:13-20)."""
    if console is not None:
        if style:
            console.print(msg, style=style)
        else:
            console.print(msg)
    else:
        print(msg)


class _NullProgress:
    """Progress stand-in when no rich console is attached."""

    def update(self, task, **kwargs):
        pass

    def advance(self, task, advance=1):
        pass


@contextmanager
def progress_bar(console=None, total=1, description="Working"):
    """Spinner and bar progress context (ref: grid/utils/utils.py:23-43).

    Yields ``(progress, task)``. A console that is not a ``rich`` console
    (None, or a recorder of log lines) gets a progress object that does
    nothing, so step code is branch-free."""
    try:
        from rich.console import Console
        from rich.progress import (
            BarColumn, Progress, SpinnerColumn, TaskProgressColumn, TextColumn, TimeElapsedColumn,
        )
    except ImportError:
        Console = None
    if Console is None or not isinstance(console, Console):
        yield _NullProgress(), None
        return
    with Progress(
        SpinnerColumn(spinner_name="dots", style="info"),
        TextColumn("[progress.description]{task.description}", style="highlight"),
        BarColumn(complete_style="success", finished_style="success"),
        TaskProgressColumn(),
        TimeElapsedColumn(),
        console=console,
    ) as progress:
        task = progress.add_task(description, total=total)
        yield progress, task
