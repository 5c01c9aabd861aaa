"""Protocol layer: parameters, LUTs, keys, Sender and Detector."""
