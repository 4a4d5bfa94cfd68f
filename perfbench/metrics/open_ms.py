"""Host clock of ``PhotoEditor.open`` through a synchronize, in set-up:
container parse, LJPEG decode, upload, normalize and demosaic."""


def read(ctx):
    return ctx.get("open_ms")
