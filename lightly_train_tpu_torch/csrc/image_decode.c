/* Host-side image decoding for the data loader.
 *
 * A JPEG decoder (baseline and extended sequential, progressive; Huffman
 * coding, 8-bit samples, 1 or 3 components, sampling factors 1 or 2) whose
 * output is libjpeg-turbo's with its default settings (what PIL's decoder
 * gives, draft scales included):
 *   - the ISLOW integer IDCT (jidctint.c: CONST_BITS 13, PASS1_BITS 2), and
 *     at output scales 1/2, 1/4 and 1/8 the reduced IDCTs of jidctred.c,
 *     with jdmaster.c's per-component choice of the IDCT size (a subsampled
 *     chroma component takes a larger IDCT instead of upsampling where the
 *     sampling factors allow);
 *   - jdsample.c's fancy upsampling (h2v1, h1v2, h2v2; edges replicated),
 *     off at scale 1/8 and for components at most 2 samples wide, where
 *     samples are replicated;
 *   - jdcolor.c's fixed-point YCbCr -> RGB tables.
 * IDCT outputs are clamped to 0..255 as libjpeg-turbo's SIMD IDCTs do.
 *
 * And the PNG scanline unfilter (None, Sub, Up, Average, Paeth), and one
 * pass of PIL's 8-bit bilinear resampling (Resample.c) with taps computed
 * by the caller.
 *
 * Buffers in, uint8 HWC out; every entry point returns 0 or an LT_E* code,
 * which the Python side turns into a DatasetError naming the file.
 */

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

enum {
  LT_OK = 0,
  LT_E_TRUNCATED = 1,
  LT_E_CORRUPT = 2,
  LT_E_ARITHMETIC = 3,
  LT_E_PRECISION = 4,
  LT_E_LOSSLESS = 5,
  LT_E_HIERARCHICAL = 6,
  LT_E_COMPONENTS = 7,
  LT_E_SAMPLING = 8,
  LT_E_NOMEM = 9,
  LT_E_ARGUMENT = 10,
  LT_E_FILTER = 11,
};

/* ------------------------------------------------------------------------
 * PNG
 * ------------------------------------------------------------------------ */

static int paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = abs(p - a), pb = abs(p - b), pc = abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  if (pb <= pc) return b;
  return c;
}

/* ``in`` holds ``rows`` scanlines of one filter byte and ``rowbytes`` bytes
 * each; ``out`` receives the ``rows * rowbytes`` unfiltered bytes. ``bpp``
 * is the byte distance to the pixel on the left (at least 1). */
int lt_png_unfilter(const uint8_t *in, uint8_t *out, int64_t rows,
                    int64_t rowbytes, int32_t bpp) {
  if (rows < 0 || rowbytes < 0 || bpp < 1) return LT_E_ARGUMENT;
  const uint8_t *prev = NULL;
  for (int64_t y = 0; y < rows; y++) {
    const uint8_t *src = in + y * (rowbytes + 1);
    uint8_t *dst = out + y * rowbytes;
    int filter = *src++;
    int64_t i;
    switch (filter) {
      case 0:
        memcpy(dst, src, (size_t)rowbytes);
        break;
      case 1:
        for (i = 0; i < rowbytes; i++)
          dst[i] = (uint8_t)(src[i] + (i >= bpp ? dst[i - bpp] : 0));
        break;
      case 2:
        for (i = 0; i < rowbytes; i++)
          dst[i] = (uint8_t)(src[i] + (prev ? prev[i] : 0));
        break;
      case 3:
        for (i = 0; i < rowbytes; i++) {
          int a = i >= bpp ? dst[i - bpp] : 0, b = prev ? prev[i] : 0;
          dst[i] = (uint8_t)(src[i] + ((a + b) >> 1));
        }
        break;
      case 4:
        for (i = 0; i < rowbytes; i++) {
          int a = i >= bpp ? dst[i - bpp] : 0, b = prev ? prev[i] : 0;
          int c = (i >= bpp && prev) ? prev[i - bpp] : 0;
          dst[i] = (uint8_t)(src[i] + paeth(a, b, c));
        }
        break;
      default:
        return LT_E_FILTER;
    }
    prev = dst;
  }
  return LT_OK;
}

/* ------------------------------------------------------------------------
 * Resampling
 * ------------------------------------------------------------------------ */

/* One pass of PIL's 8-bit resampling (ImagingResampleHorizontal/Vertical_
 * 8bpc): ``in`` is (outer, in_n, inner) uint8, ``out`` (outer, out_n,
 * inner); output x takes the ``ksize`` taps index[x * ksize + j] with
 * fixed-point weights coeff[x * ksize + j] (22 fraction bits, 0 past the
 * window), plus a half unit, shifted back and clipped to 0..255. */
int lt_resample_axis(const uint8_t *in, uint8_t *out, int64_t outer,
                     int64_t in_n, int64_t inner, int64_t out_n,
                     const int64_t *index, const int64_t *coeff,
                     int32_t ksize) {
  if (outer < 0 || in_n < 1 || inner < 1 || out_n < 0 || ksize < 1)
    return LT_E_ARGUMENT;
  for (int64_t x = 0; x < out_n * ksize; x++)
    if (index[x] < 0 || index[x] >= in_n) return LT_E_ARGUMENT;
  for (int64_t o = 0; o < outer; o++) {
    const uint8_t *src = in + o * in_n * inner;
    uint8_t *dst = out + o * out_n * inner;
    for (int64_t x = 0; x < out_n; x++) {
      const int64_t *ix = index + x * ksize, *k = coeff + x * ksize;
      for (int64_t i = 0; i < inner; i++) {
        int64_t acc = (int64_t)1 << 21;
        for (int j = 0; j < ksize; j++) acc += src[ix[j] * inner + i] * k[j];
        acc >>= 22;
        dst[x * inner + i] = (uint8_t)(acc < 0 ? 0 : acc > 255 ? 255 : acc);
      }
    }
  }
  return LT_OK;
}

/* ------------------------------------------------------------------------
 * JPEG: tables and bitstream
 * ------------------------------------------------------------------------ */

/* Zigzag index -> natural index, padded with 63s so that a corrupt run
 * length lands on the last coefficient (as libjpeg's jpeg_natural_order). */
static const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

#define LOOK_BITS 9

typedef struct {
  int present;
  uint8_t vals[256];
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint16_t look[1 << LOOK_BITS]; /* (length << 8) | value; 0: slow path */
} Huff;

typedef struct {
  int id, h, v, tq;
  int wib, hib;   /* blocks holding image data (width/height_in_blocks) */
  int bw, bh;     /* blocks allocated (MCU-padded) */
  int16_t *coef;  /* bw * bh blocks of 64, natural order */
  int dc_tbl, ac_tbl;
  int pred;
  int latched;
  uint16_t qt[64]; /* natural order, latched at the component's first scan */
  int ssize;       /* IDCT output size: 1, 2, 4 or 8 */
  int dw, dh;      /* downsampled_width / _height at that size */
} Comp;

typedef struct {
  const uint8_t *buf;
  size_t n, pos;
  uint16_t q[4][64];
  int qset[4];
  Huff dc[4], ac[4];
  Comp comp[3];
  int ncomp, width, height, progressive, maxh, maxv, mcux, mcuy;
  int restart_interval;
  int jfif, adobe, adobe_transform;
  int frame_seen;
  /* bit reader */
  uint64_t bits;
  int nbits;
  int at_marker; /* the reader stopped at a marker: zeros follow */
  int ran_out;   /* the reader ran past the end of the buffer */
  int eobrun;
} Jpeg;

static void reset_reader(Jpeg *j) {
  j->bits = 0;
  j->nbits = 0;
  j->at_marker = 0;
}

static void fill(Jpeg *j) {
  while (j->nbits <= 56) {
    unsigned byte = 0;
    if (!j->at_marker) {
      if (j->pos >= j->n) {
        j->ran_out = 1;
        j->at_marker = 1;
      } else {
        byte = j->buf[j->pos];
        if (byte != 0xFF) {
          j->pos++;
        } else {
          size_t p = j->pos + 1;
          while (p < j->n && j->buf[p] == 0xFF) p++;
          if (p >= j->n) {
            j->ran_out = 1;
            j->at_marker = 1;
            byte = 0;
          } else if (j->buf[p] == 0x00) {
            j->pos = p + 1; /* stuffed 0xFF */
          } else {
            j->at_marker = 1; /* a marker: leave it for the parser */
            byte = 0;
          }
        }
      }
    }
    j->bits |= (uint64_t)byte << (56 - j->nbits);
    j->nbits += 8;
  }
}

static inline int get_bits(Jpeg *j, int n) {
  if (n == 0) return 0;
  if (j->nbits < n) fill(j);
  int v = (int)(j->bits >> (64 - n));
  j->bits <<= n;
  j->nbits -= n;
  return v;
}

static inline int extend(int v, int s) {
  return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
}

static int decode_huff(Jpeg *j, const Huff *h) {
  if (j->nbits < 16) fill(j);
  unsigned e = h->look[j->bits >> (64 - LOOK_BITS)];
  if (e) {
    int len = (int)(e >> 8);
    j->bits <<= len;
    j->nbits -= len;
    return (int)(e & 0xFF);
  }
  int code = 0;
  for (int l = 1; l <= 16; l++) {
    code = (code << 1) | (int)(j->bits >> 63);
    j->bits <<= 1;
    j->nbits--;
    if (code <= h->maxcode[l]) return h->vals[(code + h->valoffset[l]) & 0xFF];
  }
  return 0; /* a bad code: libjpeg warns and decodes a zero */
}

/* jdhuff.c's jpeg_make_d_derived_tbl, plus a LOOK_BITS lookahead table. */
static int build_huff(Huff *h, const uint8_t *counts, const uint8_t *vals,
                      int nvals) {
  int size[257], code[257];
  int p = 0;
  for (int l = 1; l <= 16; l++)
    for (int i = 0; i < counts[l - 1]; i++) size[p++] = l;
  size[p] = 0;
  int c = 0, si = size[0];
  p = 0;
  while (size[p]) {
    while (size[p] == si) code[p++] = c++;
    if (c >= (1 << si)) return LT_E_CORRUPT;
    c <<= 1;
    si++;
  }
  p = 0;
  for (int l = 1; l <= 16; l++) {
    if (counts[l - 1]) {
      h->valoffset[l] = p - code[p];
      p += counts[l - 1];
      h->maxcode[l] = code[p - 1];
    } else {
      h->maxcode[l] = -1;
    }
  }
  h->valoffset[17] = 0;
  h->maxcode[17] = 0xFFFFF;
  memset(h->vals, 0, sizeof(h->vals));
  memcpy(h->vals, vals, (size_t)nvals);
  memset(h->look, 0, sizeof(h->look));
  p = 0;
  for (int l = 1; l <= LOOK_BITS; l++) {
    for (int i = 0; i < counts[l - 1]; i++, p++) {
      int first = code[p] << (LOOK_BITS - l);
      for (int k = 0; k < (1 << (LOOK_BITS - l)); k++)
        h->look[first + k] = (uint16_t)((l << 8) | vals[p]);
    }
  }
  h->present = 1;
  return LT_OK;
}

/* ------------------------------------------------------------------------
 * JPEG: markers
 * ------------------------------------------------------------------------ */

static int read_u16(Jpeg *j, unsigned *v) {
  if (j->pos + 2 > j->n) return LT_E_TRUNCATED;
  *v = ((unsigned)j->buf[j->pos] << 8) | j->buf[j->pos + 1];
  j->pos += 2;
  return LT_OK;
}

/* The next marker code at or after pos (garbage and fill bytes skipped, as
 * libjpeg's next_marker); pos ends just past it. */
static int next_marker(Jpeg *j, int *code) {
  for (;;) {
    while (j->pos < j->n && j->buf[j->pos] != 0xFF) j->pos++;
    while (j->pos < j->n && j->buf[j->pos] == 0xFF) j->pos++;
    if (j->pos >= j->n) return LT_E_TRUNCATED;
    int c = j->buf[j->pos++];
    if (c != 0) {
      *code = c;
      return LT_OK;
    }
  }
}

static int parse_sof(Jpeg *j, const uint8_t *s, unsigned len) {
  if (len < 6) return LT_E_CORRUPT;
  if (s[0] != 8) return LT_E_PRECISION;
  j->height = (s[1] << 8) | s[2];
  j->width = (s[3] << 8) | s[4];
  int nc = s[5];
  if (j->width == 0 || j->height == 0) return LT_E_CORRUPT;
  if (nc != 1 && nc != 3) return LT_E_COMPONENTS;
  if (len < 6u + 3u * (unsigned)nc) return LT_E_CORRUPT;
  j->ncomp = nc;
  j->maxh = j->maxv = 1;
  for (int i = 0; i < nc; i++) {
    Comp *c = &j->comp[i];
    memset(c, 0, sizeof(*c));
    c->id = s[6 + 3 * i];
    c->h = s[7 + 3 * i] >> 4;
    c->v = s[7 + 3 * i] & 15;
    c->tq = s[8 + 3 * i] & 3;
    if (c->h < 1 || c->h > 2 || c->v < 1 || c->v > 2) return LT_E_SAMPLING;
    if (c->h > j->maxh) j->maxh = c->h;
    if (c->v > j->maxv) j->maxv = c->v;
  }
  j->mcux = (j->width + 8 * j->maxh - 1) / (8 * j->maxh);
  j->mcuy = (j->height + 8 * j->maxv - 1) / (8 * j->maxv);
  for (int i = 0; i < nc; i++) {
    Comp *c = &j->comp[i];
    c->wib = (int)(((int64_t)j->width * c->h + 8 * j->maxh - 1) /
                   (8 * j->maxh));
    c->hib = (int)(((int64_t)j->height * c->v + 8 * j->maxv - 1) /
                   (8 * j->maxv));
    c->bw = j->mcux * c->h;
    c->bh = j->mcuy * c->v;
  }
  j->frame_seen = 1;
  return LT_OK;
}

static int parse_dqt(Jpeg *j, const uint8_t *s, unsigned len) {
  unsigned p = 0;
  while (p < len) {
    int pq = s[p] >> 4, tq = s[p] & 15;
    p++;
    if (tq > 3 || pq > 1) return LT_E_CORRUPT;
    unsigned need = pq ? 128 : 64;
    if (p + need > len) return LT_E_CORRUPT;
    for (int i = 0; i < 64; i++) {
      unsigned v = pq ? ((unsigned)s[p + 2 * i] << 8) | s[p + 2 * i + 1]
                      : s[p + i];
      j->q[tq][kNatural[i]] = (uint16_t)v;
    }
    j->qset[tq] = 1;
    p += need;
  }
  return LT_OK;
}

static int parse_dht(Jpeg *j, const uint8_t *s, unsigned len) {
  unsigned p = 0;
  while (p < len) {
    if (p + 17 > len) return LT_E_CORRUPT;
    int tc = s[p] >> 4, th = s[p] & 15;
    if (tc > 1 || th > 3) return LT_E_CORRUPT;
    const uint8_t *counts = s + p + 1;
    int total = 0;
    for (int i = 0; i < 16; i++) total += counts[i];
    if (total > 256 || p + 17 + (unsigned)total > len) return LT_E_CORRUPT;
    int err = build_huff(tc ? &j->ac[th] : &j->dc[th], counts, s + p + 17,
                         total);
    if (err) return err;
    p += 17 + (unsigned)total;
  }
  return LT_OK;
}

static void parse_app(Jpeg *j, int code, const uint8_t *s, unsigned len) {
  /* jdmarker.c's examine_app0 / examine_app14 */
  if (code == 0xE0 && len >= 14 && memcmp(s, "JFIF\0", 5) == 0) j->jfif = 1;
  if (code == 0xEE && len >= 12 && memcmp(s, "Adobe", 5) == 0) {
    j->adobe = 1;
    j->adobe_transform = s[11];
  }
}

/* jdapimin.c's default_decompress_parms for 3 components: nonzero if the
 * components are YCbCr, zero if RGB. */
static int is_ycc(const Jpeg *j) {
  if (j->jfif) return 1;
  if (j->adobe) return j->adobe_transform != 0;
  if (j->comp[0].id == 82 && j->comp[1].id == 71 && j->comp[2].id == 66)
    return 0;
  return 1;
}

/* ------------------------------------------------------------------------
 * JPEG: entropy decoding
 * ------------------------------------------------------------------------ */

static void decode_block_seq(Jpeg *j, Comp *c, int16_t *blk) {
  int t = decode_huff(j, &j->dc[c->dc_tbl]);
  int diff = t ? extend(get_bits(j, t > 16 ? 16 : t), t > 16 ? 16 : t) : 0;
  c->pred += diff;
  blk[0] = (int16_t)c->pred;
  const Huff *ac = &j->ac[c->ac_tbl];
  for (int k = 1; k < 64; k++) {
    int rs = decode_huff(j, ac);
    int r = rs >> 4, s = rs & 15;
    if (s) {
      k += r;
      blk[kNatural[k]] = (int16_t)extend(get_bits(j, s), s);
    } else {
      if (r != 15) break;
      k += 15;
    }
  }
}

static void decode_dc_first(Jpeg *j, Comp *c, int16_t *blk, int al) {
  int t = decode_huff(j, &j->dc[c->dc_tbl]);
  int diff = t ? extend(get_bits(j, t > 16 ? 16 : t), t > 16 ? 16 : t) : 0;
  c->pred += diff;
  blk[0] = (int16_t)((unsigned)c->pred << al);
}

static void decode_dc_refine(Jpeg *j, int16_t *blk, int al) {
  if (get_bits(j, 1)) blk[0] = (int16_t)(blk[0] | (1 << al));
}

static void decode_ac_first(Jpeg *j, Comp *c, int16_t *blk, int ss, int se,
                            int al) {
  if (j->eobrun > 0) {
    j->eobrun--;
    return;
  }
  const Huff *ac = &j->ac[c->ac_tbl];
  for (int k = ss; k <= se; k++) {
    int rs = decode_huff(j, ac);
    int r = rs >> 4, s = rs & 15;
    if (s) {
      k += r;
      blk[kNatural[k]] = (int16_t)((unsigned)extend(get_bits(j, s), s) << al);
    } else if (r == 15) {
      k += 15;
    } else {
      j->eobrun = 1 << r;
      if (r) j->eobrun += get_bits(j, r);
      j->eobrun--;
      break;
    }
  }
}

/* jdphuff.c's decode_mcu_AC_refine. */
static void decode_ac_refine(Jpeg *j, Comp *c, int16_t *blk, int ss, int se,
                             int al) {
  int p1 = 1 << al, m1 = -1 * (1 << al);
  const Huff *ac = &j->ac[c->ac_tbl];
  int k = ss;
  if (j->eobrun == 0) {
    for (; k <= se; k++) {
      int rs = decode_huff(j, ac);
      int r = rs >> 4, s = rs & 15;
      if (s) {
        s = get_bits(j, 1) ? p1 : m1;
      } else if (r != 15) {
        j->eobrun = 1 << r;
        if (r) j->eobrun += get_bits(j, r);
        break;
      }
      do {
        int16_t *coef = blk + kNatural[k];
        if (*coef != 0) {
          if (get_bits(j, 1) && (*coef & p1) == 0)
            *coef = (int16_t)(*coef >= 0 ? *coef + p1 : *coef + m1);
        } else {
          if (--r < 0) break;
        }
        k++;
      } while (k <= se);
      if (s) blk[kNatural[k]] = (int16_t)s;
    }
  }
  if (j->eobrun > 0) {
    for (; k <= se; k++) {
      int16_t *coef = blk + kNatural[k];
      if (*coef != 0 && get_bits(j, 1) && (*coef & p1) == 0)
        *coef = (int16_t)(*coef >= 0 ? *coef + p1 : *coef + m1);
    }
    j->eobrun--;
  }
}

static int16_t *block_at(Comp *c, int bx, int by) {
  return c->coef + ((size_t)by * c->bw + bx) * 64;
}

static void decode_one(Jpeg *j, Comp *c, int16_t *blk, int ss, int se,
                       int ah, int al) {
  if (!j->progressive)
    decode_block_seq(j, c, blk);
  else if (ss == 0)
    ah ? decode_dc_refine(j, blk, al) : decode_dc_first(j, c, blk, al);
  else
    ah ? decode_ac_refine(j, c, blk, ss, se, al)
       : decode_ac_first(j, c, blk, ss, se, al);
}

/* jdhuff.c's process_restart: discard the bits left, expect RSTn. */
static int process_restart(Jpeg *j, int *next_rst) {
  int code;
  reset_reader(j);
  int err = next_marker(j, &code);
  if (err) return err;
  if (code != 0xD0 + *next_rst) return LT_E_CORRUPT;
  *next_rst = (*next_rst + 1) & 7;
  for (int i = 0; i < j->ncomp; i++) j->comp[i].pred = 0;
  j->eobrun = 0;
  return LT_OK;
}

static int decode_scan(Jpeg *j, const uint8_t *s, unsigned len) {
  if (!j->frame_seen || len < 1) return LT_E_CORRUPT;
  int ns = s[0];
  if (ns < 1 || ns > j->ncomp || len < 4u + 2u * (unsigned)ns)
    return LT_E_CORRUPT;
  Comp *sc[3];
  for (int i = 0; i < ns; i++) {
    int id = s[1 + 2 * i], k;
    for (k = 0; k < j->ncomp && j->comp[k].id != id; k++) {
    }
    if (k == j->ncomp) return LT_E_CORRUPT;
    sc[i] = &j->comp[k];
    sc[i]->dc_tbl = s[2 + 2 * i] >> 4 & 3;
    sc[i]->ac_tbl = s[2 + 2 * i] & 3;
  }
  int ss = s[1 + 2 * ns], se = s[2 + 2 * ns];
  int ah = s[3 + 2 * ns] >> 4, al = s[3 + 2 * ns] & 15;
  if (j->progressive) {
    if (ss > se || se > 63 || al > 13 || (ss == 0 && se != 0) ||
        (ss > 0 && ns != 1))
      return LT_E_CORRUPT;
  } else {
    ss = 0;
    se = 63;
    ah = al = 0;
  }
  for (int i = 0; i < ns; i++) {
    Comp *c = sc[i];
    int need_dc = !j->progressive || (ss == 0 && ah == 0);
    int need_ac = !j->progressive ? 1 : ss > 0;
    if ((need_dc && !j->dc[c->dc_tbl].present) ||
        (need_ac && !j->ac[c->ac_tbl].present))
      return LT_E_CORRUPT;
    if (!c->latched) { /* jdinput.c's latch_quant_tables */
      if (!j->qset[c->tq]) return LT_E_CORRUPT;
      memcpy(c->qt, j->q[c->tq], sizeof(c->qt));
      c->latched = 1;
    }
    c->pred = 0;
  }
  reset_reader(j);
  j->eobrun = 0;
  int next_rst = 0, left = j->restart_interval;
  int mx_n = ns == 1 ? sc[0]->wib : j->mcux;
  int my_n = ns == 1 ? sc[0]->hib : j->mcuy;
  for (int my = 0; my < my_n; my++) {
    for (int mx = 0; mx < mx_n; mx++) {
      if (j->restart_interval) {
        if (left == 0) {
          int err = process_restart(j, &next_rst);
          if (err) return err;
          left = j->restart_interval;
        }
        left--;
      }
      if (ns == 1) {
        decode_one(j, sc[0], block_at(sc[0], mx, my), ss, se, ah, al);
      } else {
        for (int i = 0; i < ns; i++) {
          Comp *c = sc[i];
          for (int v = 0; v < c->v; v++)
            for (int h = 0; h < c->h; h++)
              decode_one(j, c, block_at(c, mx * c->h + h, my * c->v + v),
                         ss, se, ah, al);
        }
      }
      if (j->ran_out) return LT_E_TRUNCATED;
    }
  }
  reset_reader(j);
  return LT_OK;
}

/* Parse markers from SOI. With ``decode`` zero, stop after the frame
 * header; otherwise decode every scan up to EOI. */
static int parse(Jpeg *j, int decode) {
  if (j->n < 2 || j->buf[0] != 0xFF || j->buf[1] != 0xD8) return LT_E_CORRUPT;
  j->pos = 2;
  for (;;) {
    int code, err = next_marker(j, &code);
    if (err) return err;
    if (code == 0xD9) return j->frame_seen ? LT_OK : LT_E_CORRUPT;
    if ((code >= 0xD0 && code <= 0xD7) || code == 0x01 || code == 0xD8)
      continue; /* no payload */
    unsigned len;
    err = read_u16(j, &len);
    if (err) return err;
    if (len < 2) return LT_E_CORRUPT;
    len -= 2;
    if (j->pos + len > j->n) return LT_E_TRUNCATED;
    const uint8_t *s = j->buf + j->pos;
    j->pos += len;
    switch (code) {
      case 0xC0:
      case 0xC1:
      case 0xC2:
        if (j->frame_seen) return LT_E_CORRUPT;
        j->progressive = code == 0xC2;
        err = parse_sof(j, s, len);
        if (err) return err;
        if (!decode) return LT_OK;
        for (int i = 0; i < j->ncomp; i++) {
          Comp *c = &j->comp[i];
          c->coef = calloc((size_t)c->bw * c->bh * 64, sizeof(int16_t));
          if (!c->coef) return LT_E_NOMEM;
        }
        break;
      case 0xC3:
        return LT_E_LOSSLESS;
      case 0xC5:
      case 0xC6:
      case 0xC7:
      case 0xDE:
      case 0xDF:
        return LT_E_HIERARCHICAL;
      case 0xC9:
      case 0xCA:
      case 0xCB:
      case 0xCC:
      case 0xCD:
      case 0xCE:
      case 0xCF:
        return LT_E_ARITHMETIC;
      case 0xC4:
        err = parse_dht(j, s, len);
        break;
      case 0xDB:
        err = parse_dqt(j, s, len);
        break;
      case 0xDD:
        if (len < 2) return LT_E_CORRUPT;
        j->restart_interval = (s[0] << 8) | s[1];
        break;
      case 0xDA:
        err = decode_scan(j, s, len);
        break;
      case 0xDC: /* DNL: a height given after the first scan */
        return LT_E_CORRUPT;
      default:
        if (code >= 0xE0 && code <= 0xEF) parse_app(j, code, s, len);
        break;
    }
    if (err) return err;
  }
}

static void free_jpeg(Jpeg *j) {
  for (int i = 0; i < 3; i++) free(j->comp[i].coef);
}

/* ------------------------------------------------------------------------
 * JPEG: IDCTs (jidctint.c's jpeg_idct_islow, jidctred.c's 4x4/2x2/1x1)
 * ------------------------------------------------------------------------ */

#define CONST_BITS 13
#define PASS1_BITS 2
#define DESCALE(x, n) (((x) + ((int64_t)1 << ((n)-1))) >> (n))

static inline uint8_t clamp_sample(int64_t v) {
  v += 128;
  return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v);
}

static void idct_8x8(const int16_t *in, const uint16_t *q, uint8_t *out,
                     int stride) {
  int ws[64];
  for (int c = 0; c < 8; c++) {
    const int16_t *ip = in + c;
    const uint16_t *qp = q + c;
    int *wp = ws + c;
    if (!ip[8] && !ip[16] && !ip[24] && !ip[32] && !ip[40] && !ip[48] &&
        !ip[56]) {
      int dc = (ip[0] * qp[0]) * (1 << PASS1_BITS);
      for (int r = 0; r < 8; r++) wp[8 * r] = dc;
      continue;
    }
    int64_t z2 = ip[16] * qp[16], z3 = ip[48] * qp[48];
    int64_t z1 = (z2 + z3) * 4433;
    int64_t tmp2 = z1 + z3 * -15137, tmp3 = z1 + z2 * 6270;
    z2 = ip[0] * qp[0];
    z3 = ip[32] * qp[32];
    int64_t tmp0 = (z2 + z3) * (1 << CONST_BITS);
    int64_t tmp1 = (z2 - z3) * (1 << CONST_BITS);
    int64_t t10 = tmp0 + tmp3, t13 = tmp0 - tmp3;
    int64_t t11 = tmp1 + tmp2, t12 = tmp1 - tmp2;
    tmp0 = ip[56] * qp[56];
    tmp1 = ip[40] * qp[40];
    tmp2 = ip[24] * qp[24];
    tmp3 = ip[8] * qp[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * 9633;
    tmp0 *= 2446;
    tmp1 *= 16819;
    tmp2 *= 25172;
    tmp3 *= 12299;
    z1 *= -7373;
    z2 *= -20995;
    z3 *= -16069;
    z4 *= -3196;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int sh = CONST_BITS - PASS1_BITS;
    wp[0] = (int)DESCALE(t10 + tmp3, sh);
    wp[56] = (int)DESCALE(t10 - tmp3, sh);
    wp[8] = (int)DESCALE(t11 + tmp2, sh);
    wp[48] = (int)DESCALE(t11 - tmp2, sh);
    wp[16] = (int)DESCALE(t12 + tmp1, sh);
    wp[40] = (int)DESCALE(t12 - tmp1, sh);
    wp[24] = (int)DESCALE(t13 + tmp0, sh);
    wp[32] = (int)DESCALE(t13 - tmp0, sh);
  }
  for (int r = 0; r < 8; r++) {
    const int *wp = ws + 8 * r;
    uint8_t *op = out + (size_t)r * stride;
    const int sh = CONST_BITS + PASS1_BITS + 3;
    int64_t z2 = wp[2], z3 = wp[6];
    int64_t z1 = (z2 + z3) * 4433;
    int64_t tmp2 = z1 + z3 * -15137, tmp3 = z1 + z2 * 6270;
    int64_t tmp0 = ((int64_t)wp[0] + wp[4]) * (1 << CONST_BITS);
    int64_t tmp1 = ((int64_t)wp[0] - wp[4]) * (1 << CONST_BITS);
    int64_t t10 = tmp0 + tmp3, t13 = tmp0 - tmp3;
    int64_t t11 = tmp1 + tmp2, t12 = tmp1 - tmp2;
    tmp0 = wp[7];
    tmp1 = wp[5];
    tmp2 = wp[3];
    tmp3 = wp[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * 9633;
    tmp0 *= 2446;
    tmp1 *= 16819;
    tmp2 *= 25172;
    tmp3 *= 12299;
    z1 *= -7373;
    z2 *= -20995;
    z3 *= -16069;
    z4 *= -3196;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    op[0] = clamp_sample(DESCALE(t10 + tmp3, sh));
    op[7] = clamp_sample(DESCALE(t10 - tmp3, sh));
    op[1] = clamp_sample(DESCALE(t11 + tmp2, sh));
    op[6] = clamp_sample(DESCALE(t11 - tmp2, sh));
    op[2] = clamp_sample(DESCALE(t12 + tmp1, sh));
    op[5] = clamp_sample(DESCALE(t12 - tmp1, sh));
    op[3] = clamp_sample(DESCALE(t13 + tmp0, sh));
    op[4] = clamp_sample(DESCALE(t13 - tmp0, sh));
  }
}

static void idct_4x4(const int16_t *in, const uint16_t *q, uint8_t *out,
                     int stride) {
  int ws[32];
  for (int c = 0; c < 8; c++) {
    if (c == 4) continue; /* column 4 feeds no 4x4 output */
    const int16_t *ip = in + c;
    const uint16_t *qp = q + c;
    int *wp = ws + c;
    if (!ip[8] && !ip[16] && !ip[24] && !ip[40] && !ip[48] && !ip[56]) {
      int dc = (ip[0] * qp[0]) * (1 << PASS1_BITS);
      wp[0] = wp[8] = wp[16] = wp[24] = dc;
      continue;
    }
    int64_t tmp0 = (int64_t)(ip[0] * qp[0]) * (1 << (CONST_BITS + 1));
    int64_t z2 = ip[16] * qp[16], z3 = ip[48] * qp[48];
    int64_t tmp2 = z2 * 15137 + z3 * -6270;
    int64_t t10 = tmp0 + tmp2, t12 = tmp0 - tmp2;
    int64_t z1 = ip[56] * qp[56];
    z2 = ip[40] * qp[40];
    z3 = ip[24] * qp[24];
    int64_t z4 = ip[8] * qp[8];
    tmp0 = z1 * -1730 + z2 * 11893 + z3 * -17799 + z4 * 8697;
    tmp2 = z1 * -4176 + z2 * -4926 + z3 * 7373 + z4 * 20995;
    const int sh = CONST_BITS - PASS1_BITS + 1;
    wp[0] = (int)DESCALE(t10 + tmp2, sh);
    wp[24] = (int)DESCALE(t10 - tmp2, sh);
    wp[8] = (int)DESCALE(t12 + tmp0, sh);
    wp[16] = (int)DESCALE(t12 - tmp0, sh);
  }
  for (int r = 0; r < 4; r++) {
    const int *wp = ws + 8 * r;
    uint8_t *op = out + (size_t)r * stride;
    const int sh = CONST_BITS + PASS1_BITS + 3 + 1;
    int64_t tmp0 = (int64_t)wp[0] * (1 << (CONST_BITS + 1));
    int64_t tmp2 = (int64_t)wp[2] * 15137 + (int64_t)wp[6] * -6270;
    int64_t t10 = tmp0 + tmp2, t12 = tmp0 - tmp2;
    int64_t z1 = wp[7], z2 = wp[5], z3 = wp[3], z4 = wp[1];
    tmp0 = z1 * -1730 + z2 * 11893 + z3 * -17799 + z4 * 8697;
    tmp2 = z1 * -4176 + z2 * -4926 + z3 * 7373 + z4 * 20995;
    op[0] = clamp_sample(DESCALE(t10 + tmp2, sh));
    op[3] = clamp_sample(DESCALE(t10 - tmp2, sh));
    op[1] = clamp_sample(DESCALE(t12 + tmp0, sh));
    op[2] = clamp_sample(DESCALE(t12 - tmp0, sh));
  }
}

static void idct_2x2(const int16_t *in, const uint16_t *q, uint8_t *out,
                     int stride) {
  int ws[16];
  for (int c = 0; c < 8; c++) {
    if (c == 2 || c == 4 || c == 6) continue;
    const int16_t *ip = in + c;
    const uint16_t *qp = q + c;
    int *wp = ws + c;
    if (!ip[8] && !ip[24] && !ip[40] && !ip[56]) {
      int dc = (ip[0] * qp[0]) * (1 << PASS1_BITS);
      wp[0] = wp[8] = dc;
      continue;
    }
    int64_t t10 = (int64_t)(ip[0] * qp[0]) * (1 << (CONST_BITS + 2));
    int64_t tmp0 = (int64_t)(ip[56] * qp[56]) * -5906 +
                   (int64_t)(ip[40] * qp[40]) * 6967 +
                   (int64_t)(ip[24] * qp[24]) * -10426 +
                   (int64_t)(ip[8] * qp[8]) * 29692;
    const int sh = CONST_BITS - PASS1_BITS + 2;
    wp[0] = (int)DESCALE(t10 + tmp0, sh);
    wp[8] = (int)DESCALE(t10 - tmp0, sh);
  }
  for (int r = 0; r < 2; r++) {
    const int *wp = ws + 8 * r;
    uint8_t *op = out + (size_t)r * stride;
    const int sh = CONST_BITS + PASS1_BITS + 3 + 2;
    int64_t t10 = (int64_t)wp[0] * (1 << (CONST_BITS + 2));
    int64_t tmp0 = (int64_t)wp[7] * -5906 + (int64_t)wp[5] * 6967 +
                   (int64_t)wp[3] * -10426 + (int64_t)wp[1] * 29692;
    op[0] = clamp_sample(DESCALE(t10 + tmp0, sh));
    op[1] = clamp_sample(DESCALE(t10 - tmp0, sh));
  }
}

static void idct_1x1(const int16_t *in, const uint16_t *q, uint8_t *out,
                     int stride) {
  (void)stride;
  out[0] = clamp_sample(DESCALE((int64_t)(in[0] * q[0]), 3));
}

/* ------------------------------------------------------------------------
 * JPEG: upsampling (jdsample.c) and colour conversion (jdcolor.c)
 * ------------------------------------------------------------------------ */

/* One component's samples (dw x dh at ``stride``) to ow x oh, expanded by
 * (he, ve), into ``dst`` (ow wide). Rows past dh repeat row dh - 1 and
 * row -1 repeats row 0, as jdmainct.c's context pointers do. */
static int upsample(const uint8_t *src, int stride, int dw, int dh, int he,
                    int ve, int fancy, uint8_t *dst, int ow, int oh) {
  uint8_t *row = malloc((size_t)dw * he + 2);
  if (!row) return LT_E_NOMEM;
  int hfancy = fancy && he == 2 && dw > 2;
  for (int y = 0; y < oh; y++) {
    int iy = y / ve;
    const uint8_t *in = src + (size_t)iy * stride;
    uint8_t *o = dst + (size_t)y * ow;
    if (ve == 2 && fancy && (he == 1 || hfancy)) {
      int ny = (y & 1) ? iy + 1 : iy - 1;
      if (ny < 0) ny = 0;
      if (ny > dh - 1) ny = dh - 1;
      const uint8_t *in1 = src + (size_t)ny * stride;
      if (he == 1) { /* h1v2_fancy_upsample */
        int bias = (y & 1) ? 2 : 1;
        for (int x = 0; x < ow; x++)
          o[x] = (uint8_t)((in[x] * 3 + in1[x] + bias) >> 2);
      } else { /* h2v2_fancy_upsample */
        int this_sum = in[0] * 3 + in1[0];
        int next_sum = in[1] * 3 + in1[1];
        int last_sum;
        row[0] = (uint8_t)((this_sum * 4 + 8) >> 4);
        row[1] = (uint8_t)((this_sum * 3 + next_sum + 7) >> 4);
        last_sum = this_sum;
        this_sum = next_sum;
        for (int x = 2; x < dw; x++) {
          next_sum = in[x] * 3 + in1[x];
          row[2 * x - 2] = (uint8_t)((this_sum * 3 + last_sum + 8) >> 4);
          row[2 * x - 1] = (uint8_t)((this_sum * 3 + next_sum + 7) >> 4);
          last_sum = this_sum;
          this_sum = next_sum;
        }
        row[2 * dw - 2] = (uint8_t)((this_sum * 3 + last_sum + 8) >> 4);
        row[2 * dw - 1] = (uint8_t)((this_sum * 4 + 7) >> 4);
        memcpy(o, row, (size_t)ow);
      }
    } else if (hfancy && ve == 1) { /* h2v1_fancy_upsample */
      int v = in[0];
      row[0] = (uint8_t)v;
      row[1] = (uint8_t)((v * 3 + in[1] + 2) >> 2);
      for (int x = 1; x < dw - 1; x++) {
        v = in[x] * 3;
        row[2 * x] = (uint8_t)((v + in[x - 1] + 1) >> 2);
        row[2 * x + 1] = (uint8_t)((v + in[x + 1] + 2) >> 2);
      }
      v = in[dw - 1];
      row[2 * dw - 2] = (uint8_t)((v * 3 + in[dw - 2] + 1) >> 2);
      row[2 * dw - 1] = (uint8_t)v;
      memcpy(o, row, (size_t)ow);
    } else { /* replication (h2v1/h2v2_upsample, int_upsample) */
      for (int x = 0; x < ow; x++) o[x] = in[x / he];
    }
  }
  free(row);
  return LT_OK;
}

#define SCALEBITS 16
#define ONE_HALF ((int64_t)1 << (SCALEBITS - 1))
#define FIX(x) ((int64_t)((x) * (1L << SCALEBITS) + 0.5))

static void ycc_to_rgb(const uint8_t *y, const uint8_t *cb, const uint8_t *cr,
                       size_t n, uint8_t *out) {
  int cr_r[256], cb_b[256];
  int64_t cr_g[256], cb_g[256];
  for (int i = 0; i < 256; i++) {
    int64_t x = i - 128;
    cr_r[i] = (int)((FIX(1.40200) * x + ONE_HALF) >> SCALEBITS);
    cb_b[i] = (int)((FIX(1.77200) * x + ONE_HALF) >> SCALEBITS);
    cr_g[i] = -FIX(0.71414) * x;
    cb_g[i] = -FIX(0.34414) * x + ONE_HALF;
  }
  for (size_t i = 0; i < n; i++) {
    int l = y[i], b = cb[i], r = cr[i];
    int vr = l + cr_r[r];
    int vg = l + (int)((cb_g[b] + cr_g[r]) >> SCALEBITS);
    int vb = l + cb_b[b];
    out[3 * i] = (uint8_t)(vr < 0 ? 0 : vr > 255 ? 255 : vr);
    out[3 * i + 1] = (uint8_t)(vg < 0 ? 0 : vg > 255 ? 255 : vg);
    out[3 * i + 2] = (uint8_t)(vb < 0 ? 0 : vb > 255 ? 255 : vb);
  }
}

/* ------------------------------------------------------------------------
 * JPEG: entry points
 * ------------------------------------------------------------------------ */

/* info[0..2] = width, height, components of the frame. */
int lt_jpeg_header(const uint8_t *buf, int64_t n, int32_t *info) {
  Jpeg *j = calloc(1, sizeof(Jpeg));
  if (!j) return LT_E_NOMEM;
  j->buf = buf;
  j->n = (size_t)n;
  int err = parse(j, 0);
  if (!err && !j->frame_seen) err = LT_E_CORRUPT;
  if (!err) {
    info[0] = j->width;
    info[1] = j->height;
    info[2] = j->ncomp;
  }
  free(j);
  return err;
}

/* Decode at 1/``scale`` (1, 2, 4 or 8) into ``out``: out_h x out_w x
 * components uint8, where out_w = ceil(width / scale) and likewise out_h
 * (the caller reads them with lt_jpeg_header). */
int lt_jpeg_decode(const uint8_t *buf, int64_t n, int32_t scale,
                   uint8_t *out, int32_t out_w, int32_t out_h,
                   int32_t out_c) {
  if (scale != 1 && scale != 2 && scale != 4 && scale != 8)
    return LT_E_ARGUMENT;
  Jpeg *j = calloc(1, sizeof(Jpeg));
  if (!j) return LT_E_NOMEM;
  j->buf = buf;
  j->n = (size_t)n;
  uint8_t *planes[3] = {0}, *full[3] = {0};
  int err = parse(j, 1);
  if (err) goto done;
  if (out_w != (j->width + scale - 1) / scale ||
      out_h != (j->height + scale - 1) / scale || out_c != j->ncomp) {
    err = LT_E_ARGUMENT;
    goto done;
  }
  int m = 8 / scale; /* jdmaster.c's min_DCT_scaled_size */
  int fancy = m > 1;
  for (int i = 0; i < j->ncomp; i++) {
    Comp *c = &j->comp[i];
    /* jdmaster.c: scale a subsampled component up by its IDCT. */
    int s = m;
    while (s < 8 && (j->maxh * m) % (c->h * s * 2) == 0 &&
           (j->maxv * m) % (c->v * s * 2) == 0)
      s *= 2;
    c->ssize = s;
    c->dw = (int)(((int64_t)j->width * c->h * s + j->maxh * 8 - 1) /
                  (j->maxh * 8));
    c->dh = (int)(((int64_t)j->height * c->v * s + j->maxv * 8 - 1) /
                  (j->maxv * 8));
    int pw = c->wib * s, ph = c->hib * s;
    planes[i] = malloc((size_t)pw * ph);
    full[i] = malloc((size_t)out_w * out_h);
    if (!planes[i] || !full[i]) {
      err = LT_E_NOMEM;
      goto done;
    }
    void (*idct)(const int16_t *, const uint16_t *, uint8_t *, int) =
        s == 8 ? idct_8x8 : s == 4 ? idct_4x4 : s == 2 ? idct_2x2 : idct_1x1;
    for (int by = 0; by < c->hib; by++)
      for (int bx = 0; bx < c->wib; bx++)
        idct(block_at(c, bx, by), c->qt,
             planes[i] + (size_t)by * s * pw + (size_t)bx * s, pw);
    int he = j->maxh * m / (c->h * s), ve = j->maxv * m / (c->v * s);
    err = upsample(planes[i], pw, c->dw, c->dh, he, ve, fancy, full[i],
                   out_w, out_h);
    if (err) goto done;
  }
  size_t npix = (size_t)out_w * out_h;
  if (j->ncomp == 1) {
    memcpy(out, full[0], npix);
  } else if (is_ycc(j)) {
    ycc_to_rgb(full[0], full[1], full[2], npix, out);
  } else {
    for (size_t i = 0; i < npix; i++) {
      out[3 * i] = full[0][i];
      out[3 * i + 1] = full[1][i];
      out[3 * i + 2] = full[2][i];
    }
  }
done:
  for (int i = 0; i < 3; i++) {
    free(planes[i]);
    free(full[i]);
  }
  free_jpeg(j);
  free(j);
  return err;
}
