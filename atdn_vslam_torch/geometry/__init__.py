"""SE(3) pose math and the pose-graph solve."""
