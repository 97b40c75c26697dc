"""Image file IO and SLAM dataset readers."""
from .io import ImageLoadType, load_image, write_image
from .datasets import (KittiOdometrySequence, TrajectoryData, TUMSequence,
                       associate_timestamps, read_kitti_poses,
                       read_tum_rgbd, read_tum_trajectory)
