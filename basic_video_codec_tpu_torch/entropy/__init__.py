EOB_MARKER = 8190  # end-of-block sentinel of the DCT payload's RLE stream
