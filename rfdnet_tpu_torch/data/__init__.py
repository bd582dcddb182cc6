"""Host-side data (numpy): the ScanNet dataset and its loader, transforms,
binvox files, and synthetic scenes with a writer of the on-disk layout."""
