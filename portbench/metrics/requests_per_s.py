"""Requests answered in the window over the window's seconds: every request of
every step that started inside the window, up to the end of the last of them
(closed loop)."""


def read(ctx):
    if getattr(ctx, "window_s", None) is None:
        return None
    return ctx.window_requests / ctx.window_s
