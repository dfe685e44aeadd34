"""The image front end: pyramidal KLT, fundamental-matrix RANSAC, the KLT
and descriptor trackers."""
