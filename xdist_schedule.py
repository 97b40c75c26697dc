"""Replay a pytest-xdist `--dist loadfile` run from its JUnit XML.

The tier-1 command runs the suite under six workers with `--dist loadfile`:
each test file is one unit of work, units are queued by their number of tests
(most first, `--loadscope-reorder`, ties in collection order), and a worker
takes the next unit when it has two tests or fewer left. So files with few but
slow tests start last and set the run's wall time. This script replays that
schedule with each test's recorded time and prints each worker's finish, the
last units it took, and the simulated wall time (start-up and collection not
included). Scaling a file's times shows what cutting it would buy:

    python xdist_schedule.py run.xml
    python xdist_schedule.py run.xml --workers 6 --scale test_torch_vo=0.5
"""
import argparse
import collections
import xml.etree.ElementTree as ET


def load(path: str) -> dict:
    """{test file: [each test's seconds, in the order they ran]}."""
    root = ET.parse(path).getroot()
    suite = root if root.tag == "testsuite" else root.find("testsuite")
    files = collections.defaultdict(list)
    for case in suite.iter("testcase"):
        parts = case.attrib.get("classname", "").split(".")
        files["/".join(parts[:2]) + ".py"].append(
            float(case.attrib.get("time", 0.0)))
    return files


def replay(files: dict, workers: int) -> list:
    """Each worker's (finish time, [(start, file), ...])."""
    queue = sorted(sorted(files), key=lambda f: -len(files[f]))
    nodes = [dict(t=0.0, units=[], log=[]) for _ in range(workers)]

    def pending(n):
        return sum(len(u) for u in n["units"])

    def assign(n):
        if queue:
            f = queue.pop(0)
            n["units"].append(list(files[f]))
            n["log"].append((n["t"], f))

    for n in nodes:
        assign(n)
    for n in nodes:
        if pending(n) <= 2:
            assign(n)
    while any(pending(n) for n in nodes):
        n = min((n for n in nodes if pending(n)), key=lambda n: n["t"])
        n["t"] += n["units"][0].pop(0)
        if not n["units"][0]:
            n["units"].pop(0)
        if pending(n) <= 2:
            assign(n)
    return [(n["t"], n["log"]) for n in nodes]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("xml")
    ap.add_argument("--workers", type=int, default=6)
    ap.add_argument("--scale", nargs="*", default=[],
                    help="substring=factor: scale the times of matching files")
    args = ap.parse_args()
    files = load(args.xml)
    for item in args.scale:
        key, factor = item.split("=")
        for f in files:
            if key in f:
                files[f] = [t * float(factor) for t in files[f]]
    total = sum(sum(v) for v in files.values())
    print(f"{len(files)} files, {total:.1f} s of tests, "
          f"{total / args.workers:.1f} s a worker if evenly spread")
    done = replay(files, args.workers)
    for i, (t, log) in enumerate(done):
        tail = ", ".join(f"{f} at {s:.0f}" for s, f in log[-3:])
        print(f"worker {i}: ends at {t:.1f} s; last units {tail}")
    print(f"simulated wall time {max(t for t, _ in done):.1f} s")


if __name__ == "__main__":
    main()
