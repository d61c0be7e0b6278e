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


def shared(request, tmp_path_factory, name: str, build):
    """``build()``, once per test run: ``name`` keys the file."""
    if getattr(request.config, "workerinput", None) is None:
        return build()
    root = tmp_path_factory.getbasetemp().parent
    path = root / f"{name}.pkl"
    with open(root / f"{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
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
