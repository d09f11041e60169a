"""setup_s: seconds from the process's start to the window's (imports,
inputs and weights made on the card, the program's set-up, the warm-up of
every shape the cell uses; the first run in a checkout also builds the
kernels)."""


def read(rec):
    return rec.get("setup_s")
