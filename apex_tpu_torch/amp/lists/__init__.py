"""The O1 autocast op lists (counterpart of ``apex_tpu/amp/lists``)."""
