"""SLAM: two-view pose, visual odometry, loop closure and the optimisation back end."""
