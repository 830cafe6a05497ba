"""The error every entry point raises for a part of the reference that
the port does not have yet; a leaf module, so the runtimes and the
scenario layer above them both import it."""
from __future__ import annotations


def not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet "
        f"(ROADMAP.md queue 1, item '{item}')")
