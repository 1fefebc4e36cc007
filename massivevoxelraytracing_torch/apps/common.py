"""Command-line pieces the port's apps share: the device and the
acceleration structure."""

from __future__ import annotations


def add_device_args(ap) -> None:
    ap.add_argument("--device", default="cuda",
                    help="torch device of the build and the traversal "
                    "(default cuda; cpu runs the plain tensor versions)")
    ap.add_argument("--accel", choices=["octree", "brick", "hako"],
                    default="hako",
                    help="acceleration structure (default hako, on both "
                    "devices: the megakernel on the card)")
