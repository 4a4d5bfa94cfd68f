"""Host seconds from importing the program to the end of the warm-up:
the open, the masks, the initial edit and one tick of each kind."""


def read(ctx):
    return ctx.get("setup_s")
