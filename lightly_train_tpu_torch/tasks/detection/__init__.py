"""Detection tasks of the port: so far the COCO mAP module (``metrics.py``)."""
