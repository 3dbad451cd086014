"""The error every not-yet-ported setting raises: it names the item of
``ROADMAP.md`` ("Modules still to port") that will bring it."""


def unported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP.md, 'Modules "
        f"still to port': {item})")
