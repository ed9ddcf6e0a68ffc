#!/usr/bin/env python
"""Convert a reference-compatible ROS bag into the KAIST-style layout that
``ic_gvins_tpu_torch.tools.run_kaist`` replays (the offline stand-in for
``rosbag play`` into the reference node):

    python -m ic_gvins_tpu_torch.tools.convert_bag urban38.bag outdir \
        --imu-topic /imu/data_raw --gnss-topic /gps/fix \
        --image-topic /stereo/left/image_raw
    python -m ic_gvins_tpu_torch.tools.convert_bag urban38.bag outdir --list-topics

The arguments and the printed JSON line (the counts of what was written,
or the topics and their types) are those of the JAX package's
``tools/convert_bag.py``; the work is ``data/rosbag.convert_bag``, on the
host only.
"""

import argparse
import json


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("bag")
    ap.add_argument("outdir")
    ap.add_argument("--imu-topic", default="/imu/data_raw")
    ap.add_argument("--gnss-topic", default="/gps/fix")
    ap.add_argument("--image-topic", default=None)
    ap.add_argument("--image-format", default="png", choices=["png", "npy"])
    ap.add_argument("--list-topics", action="store_true",
                    help="print topic -> type and exit")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)

    from ..data import rosbag

    if args.list_topics:
        print(json.dumps(rosbag.bag_topics(args.bag), indent=2))
        return
    counts = rosbag.convert_bag(
        args.bag, args.outdir,
        imu_topic=args.imu_topic, gnss_topic=args.gnss_topic,
        image_topic=args.image_topic, image_format=args.image_format,
    )
    print(json.dumps(counts))


if __name__ == "__main__":
    main()
