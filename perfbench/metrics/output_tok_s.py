"""Output tokens delivered to the clients inside the window, from every
request, over the window's seconds."""


def read(run):
    return run.tokens_in_window() / (run.we - run.ws)
