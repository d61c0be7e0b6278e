"""Fixture data built once per test run and shared by the pytest-xdist
workers, the pattern pytest-xdist documents for session data: the first
worker to take the file lock builds the data and writes it, pickled, under
the run's shared base temp directory; the others wait on the lock and read
it.  Without xdist the data is simply built.

Under ``--dist load`` the tests of one module spread over the workers, and
a module fixture runs once in every worker that draws one of its tests;
the heavy reference runs (a JAX compile and a session per package) go
through :func:`shared` so they run once."""

import fcntl
import pickle


BUSY = object()


def shared(request, tmp_path_factory, name: str, build, wait: bool = True):
    """``build()``, once per test run: ``name`` keys the file.  With
    ``wait=False`` it returns :data:`BUSY` at once where another worker is
    building it."""
    if getattr(request.config, "workerinput", None) is None:
        return build()
    root = tmp_path_factory.getbasetemp().parent
    path = root / f"{name}.pkl"
    with open(root / f"{name}.lock", "w") as lock:
        try:
            fcntl.flock(lock, fcntl.LOCK_EX | (0 if wait else fcntl.LOCK_NB))
        except BlockingIOError:
            return BUSY
        try:
            if path.is_file():
                return pickle.loads(path.read_bytes())
            data = build()
            tmp = root / f"{name}.pkl.part"
            tmp.write_bytes(pickle.dumps(data))
            tmp.replace(path)
            return data
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


class Builds:
    """A module's named builds, each made on first use and once per test run
    (:func:`shared`), so that different workers make different builds at
    the same time and a test waits only for the builds it reads (making
    the others meanwhile, :meth:`build`).

    ``builds`` maps a build's name to (the keys it makes, ``fn``):
    ``fn(builds)`` returns a dict of those keys and may read other builds
    through ``builds`` (no cycles).  ``builds[key]`` is ``key``'s value."""

    def __init__(self, request, tmp_path_factory, prefix: str, builds: dict):
        self._args, self._prefix, self._memo = (request, tmp_path_factory), prefix, {}
        self._builds = builds
        self._owner = {k: name for name, (keys, _) in builds.items() for k in keys}

    def build(self, name: str, wait: bool = True):
        """Build ``name`` or read it.  Where another worker is making it,
        return :data:`BUSY` without ``wait``; with it, first make the
        module's other builds that no worker has started (in the order
        given), then wait: a worker that would wait does work instead."""
        if name not in self._memo:
            fn = self._builds[name][1]
            got = shared(*self._args, f"{self._prefix}_{name}", lambda: fn(self), wait=False)
            if got is BUSY:
                if not wait:
                    return got
                for other in self._builds:
                    if other != name and other not in self._memo:
                        self.build(other, wait=False)
                got = shared(*self._args, f"{self._prefix}_{name}", lambda: fn(self))
            self._memo[name] = got
        return self._memo[name]

    def prefetch(self, *names: str) -> None:
        """Make or read ``names``: first those no other worker is making,
        then the rest, so a test that reads several builds makes one while
        another worker makes another instead of waiting for it."""
        for name in names:
            self.build(name, wait=False)
        for name in names:
            self.build(name)

    def __getitem__(self, key):
        return self.build(self._owner[key])[key]
