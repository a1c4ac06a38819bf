"""The benchmark's TPC-DS generator: all 24 tables of the TPC Benchmark DS
specification's snowflake schema, every column, at the specification's
row counts for scale factor 1 (`scale=1.0`; a smaller `scale` shrinks
the tables that grow with the scale factor, for tests).

Written for the benchmark, not copied from the port's generator
(`hyperspace_tpu_torch/tpcds/generator.py`), which fixes its dimensions
at toy sizes. Shapes that follow the specification:

- `date_dim` runs from 1900-01-02 to 2100-01-01 with `d_date_sk` the
  Julian day number (2,415,022 onward); sales fall in the specification's
  five sales years, 1998-01-02 to 2003-01-02.
- `customer_demographics` (1,920,800 rows) is the full cross product of
  its eight attributes and `household_demographics` (7,200) of its four,
  as the specification's are; `time_dim` has a row a second.
- Every foreign key is drawn from its referenced table's key domain.
- Store sales group into tickets and catalog and web sales into orders,
  several line items each; the items of one ticket or order differ, so
  (item, ticket) and (item, order) are keys as in the specification.
- Returns are drawn from real sales rows, at the specification's SF1
  counts (about 10 % of the sales), and carry the sale's ticket or order,
  item and customer, so the ticket and order identity joins match.
- Items are a slowly changing dimension: 18,000 rows over 9,000 item ids
  with one to three revisions each; stores likewise.
- DECIMAL columns are float64, rounded to cents; dates are arrow date32.

The value distributions are this generator's choices, listed under
`assumed` in `benchmark/configs/tpcds-sf1.json`. The grammars of the values the
benchmark's queries probe are the specification's, with one exception:
`i_brand` is `brand_NN`, the brand's number within its class, because
the queries (frozen from the port, `benchmark/queries/tpcds.py`) name
brands `brand_01` .. `brand_08` where the official text names
syllable brands.

Everything is seeded and vectorised: same scale, same seed, same bytes.
"""

from __future__ import annotations

import datetime
import os
from typing import Dict

import numpy as np

# Rows at scale factor 1 (the specification's table of row counts).
SF1_ROWS = {
    "store_sales": 2_880_404,
    "store_returns": 287_514,
    "catalog_sales": 1_441_548,
    "catalog_returns": 144_067,
    "web_sales": 719_384,
    "web_returns": 71_763,
    "inventory": 11_745_000,
    "date_dim": 73_049,
    "time_dim": 86_400,
    "item": 18_000,
    "customer": 100_000,
    "customer_address": 50_000,
    "customer_demographics": 1_920_800,
    "household_demographics": 7_200,
    "promotion": 300,
    "store": 12,
    "reason": 35,
    "income_band": 20,
    "ship_mode": 20,
    "warehouse": 5,
    "web_site": 30,
    "web_page": 60,
    "call_center": 6,
    "catalog_page": 11_718,
}
TABLES = tuple(SF1_ROWS)

# Tables that shrink with `scale` below 1, and their least rows. The
# others keep their SF1 rows at every scale.
_SCALED = {"store_sales": 2000, "store_returns": 200, "catalog_sales": 1000,
           "catalog_returns": 100, "web_sales": 500, "web_returns": 50,
           "item": 600, "customer": 1000, "customer_address": 500,
           "customer_demographics": 5600, "catalog_page": 200}

_JD_OFFSET = 1_721_425           # Julian day = date.toordinal() + this
_EPOCH_ORDINAL = 719_163         # date(1970, 1, 1).toordinal()
_FIRST_DAY = datetime.date(1900, 1, 2)
_SALES_FIRST = datetime.date(1998, 1, 2)
_SALES_LAST = datetime.date(2003, 1, 2)
_INVENTORY_WEEKS = 261
_TICKET_LINES = (1, 20)          # line items of a store ticket
_ORDER_LINES = {"catalog": (1, 14), "web": (1, 18)}
_FOLLOW_SHARE = 0.5              # catalog orders that follow a store visit
_RETURN_LAG = (1, 150)           # days from a sale to its return
_NULL_SHARE = 0.02               # of the nullable keys the generator blanks


def jd(d: datetime.date) -> int:
    """`d_date_sk` of a calendar date (its Julian day number)."""
    return d.toordinal() + _JD_OFFSET


def _n_item(scale: float) -> int:
    n = max(_SCALED["item"], round(SF1_ROWS["item"] * scale))
    return n - n % 6                   # whole (1, 2, 3)-revision groups


def row_counts(scale: float = 1.0) -> Dict[str, int]:
    """The rows `generate` writes for each table at `scale` (0 < scale
    <= 1), computed without writing anything."""
    if not 0 < scale <= 1:
        raise ValueError(f"scale {scale} is outside (0, 1]")
    out = {}
    for t, n in SF1_ROWS.items():
        out[t] = max(_SCALED[t], round(n * scale)) if t in _SCALED else n
    out["item"] = _n_item(scale)
    out["inventory"] = _INVENTORY_WEEKS * (out["item"] // 2) * 5
    return out


# ---------------------------------------------------------------------------
# Value pools (the specification's grammars where a query probes them)
# ---------------------------------------------------------------------------

# dsdgen's digit syllables: names made of them spell a number.
_SYLLABLES = ("bar", "ought", "able", "pri", "ese", "anti", "cally",
              "ation", "eing", "n st")
_CATEGORIES = ("Women", "Men", "Children", "Shoes", "Music", "Jewelry",
               "Home", "Sports", "Books", "Electronics")
_CLASSES = {
    "Women": ("dresses", "fragrances", "maternity", "swimwear"),
    "Men": ("accessories", "pants", "shirts", "sports-apparel"),
    "Children": ("infants", "newborn", "school-uniforms", "toddlers"),
    "Shoes": ("athletic", "kids", "mens", "womens"),
    "Music": ("classical", "country", "pop", "rock"),
    "Jewelry": ("birdal", "bracelets", "consignment", "costume", "custom",
                "diamonds", "earings", "estate", "gold", "jewelry boxes",
                "loose stones", "mens watch", "pendants", "rings",
                "semi-precious", "womens watch"),
    "Home": ("accent", "bathroom", "bedding", "blinds/shades",
             "curtains/drapes", "decor", "flatware", "furniture",
             "glassware", "kids", "lighting", "mattresses", "paint", "rugs",
             "tables", "wallpaper"),
    "Sports": ("archery", "athletic shoes", "baseball", "basketball",
               "camping", "fishing", "fitness", "football", "golf", "guns",
               "hockey", "optics", "outdoor", "pools", "sailing", "tennis"),
    "Books": ("arts", "business", "computers", "cooking", "entertainment",
              "fiction", "history", "home repair", "mystery", "parenting",
              "reference", "romance", "science", "self-help", "sports",
              "travel"),
    "Electronics": ("audio", "automotive", "camcorders", "cameras",
                    "disk drives", "dvd/vcr players", "karoke", "memory",
                    "monitors", "musical", "personal", "portable",
                    "scanners", "stereo", "televisions", "wireless"),
}
_BRANDS_PER_CLASS = 10
_COLORS = (
    "almond", "antique", "aquamarine", "azure", "beige", "bisque", "black",
    "blanched", "blue", "blush", "brown", "burlywood", "burnished",
    "chartreuse", "chiffon", "chocolate", "coral", "cornflower", "cornsilk",
    "cream", "cyan", "dark", "deep", "dim", "dodger", "drab", "firebrick",
    "floral", "forest", "frosted", "gainsboro", "ghost", "goldenrod",
    "green", "grey", "honeydew", "hot", "indian", "ivory", "khaki", "lace",
    "lavender", "lawn", "lemon", "light", "lime", "linen", "magenta",
    "maroon", "medium", "metallic", "midnight", "mint", "misty", "moccasin",
    "navajo", "navy", "olive", "orange", "orchid", "pale", "papaya",
    "peach", "peru", "pink", "plum", "powder", "puff", "purple", "red",
    "rose", "rosy", "royal", "saddle", "salmon", "sandy", "seashell",
    "sienna", "sky", "slate", "smoke", "snow", "spring", "steel", "tan",
    "thistle", "tomato", "turquoise", "violet", "wheat", "white", "yellow")
_UNITS = ("Unknown", "Each", "Dozen", "Case", "Pallet", "Gross", "Carton",
          "Box", "Bunch", "Bundle", "Oz", "Lb", "Ton", "Ounce", "Pound",
          "Tsp", "Tbl", "Cup", "Dram", "Gram", "N/A")
_SIZES = ("petite", "small", "medium", "large", "extra large", "economy",
          "N/A")
_GENDERS = ("M", "F")
_MARITAL = ("M", "S", "D", "W", "U")
_EDUCATION = ("Primary", "Secondary", "College", "2 yr Degree",
              "4 yr Degree", "Advanced Degree", "Unknown")
_CREDIT = ("Good", "High Risk", "Low Risk", "Unknown")
_BUY_POTENTIAL = (">10000", "5001-10000", "1001-5000", "501-1000", "0-500",
                  "Unknown")
# State, weight (roughly its share of addresses), GMT offset.
_STATES = (
    ("TX", 9, -6), ("GA", 6, -5), ("VA", 5, -5), ("KY", 4, -5),
    ("MO", 4, -6), ("IL", 4, -6), ("OH", 4, -5), ("KS", 3, -6),
    ("NE", 3, -6), ("IA", 3, -6), ("MI", 3, -5), ("IN", 3, -5),
    ("NC", 3, -5), ("TN", 3, -6), ("MN", 3, -6), ("MS", 3, -6),
    ("WI", 2, -6), ("AR", 2, -6), ("OK", 2, -6), ("SD", 2, -6),
    ("ND", 2, -6), ("AL", 2, -6), ("LA", 2, -6), ("CO", 2, -7),
    ("CA", 2, -8), ("FL", 2, -5), ("NY", 2, -5), ("PA", 2, -5),
    ("WV", 2, -5), ("MT", 1, -7), ("NM", 1, -7), ("ID", 1, -7),
    ("OR", 1, -8), ("WA", 1, -8), ("SC", 1, -5), ("UT", 1, -7),
    ("ME", 1, -5), ("NJ", 1, -5), ("MD", 1, -5), ("WY", 1, -7),
    ("AZ", 1, -7), ("NV", 1, -8), ("VT", 1, -5), ("NH", 1, -5),
    ("MA", 1, -5), ("CT", 1, -5), ("AK", 1, -9), ("HI", 1, -10),
    ("DE", 1, -5), ("RI", 1, -5), ("DC", 1, -5))
_CITIES = (
    "Midway", "Fairview", "Oak Grove", "Five Points", "Pleasant Hill",
    "Riverside", "Centerville", "Mount Pleasant", "Georgetown", "Salem",
    "Greenwood", "Liberty", "Oakland", "Union", "Springfield", "Franklin",
    "Clinton", "Marion", "Greenville", "Bethel", "Lakeview", "Glendale",
    "Pleasant Grove", "Shiloh", "Concord", "Antioch", "Friendship",
    "Hopewell", "Lebanon", "Jamestown", "Highland Park", "Newport",
    "Woodville", "Wildwood", "Sulphur Springs", "Spring Hill", "Red Hill",
    "Oakwood", "Summit", "Mountain View", "Plainview", "Sunnyside",
    "Woodland", "Waterloo", "Edgewood", "Harmony", "Kingston",
    "Crossroads", "Valley View", "Hillcrest", "Enterprise", "Stringtown",
    "Macedonia", "Cedar Grove", "Jackson", "Providence", "White Oak",
    "Walnut Grove", "Lincoln", "Riverview", "Buena Vista", "Green Acres",
    "Bunker Hill", "Post Oak", "Ashland", "Arlington", "Belmont",
    "Brownsville", "Ellisville", "Deerfield", "Fairfield", "Forest Hills",
    "Garfield", "Glenwood", "Hamilton", "Highland", "Jefferson",
    "Kirkland", "Lakeside", "Lakewood", "Maple Grove", "Mount Olive",
    "Mount Vernon", "New Hope", "Oak Hill", "Oak Ridge", "Pine Grove",
    "Pleasant Valley", "Point Pleasant", "Red Oak", "Richland",
    "Rock Springs", "Rockwood", "Shady Grove", "Silver Creek",
    "Spring Valley", "Stony Point", "Sugar Hill", "Unionville", "Wilson")
_COUNTIES = (
    "Williamson County", "Ziebach County", "Walker County",
    "Daviess County", "Barrow County", "Franklin Parish", "Luce County",
    "Richland County", "Fairfield County", "Jackson County", "Levy County",
    "Bronx County", "Terrell County", "Orange County", "Mesa County",
    "Huron County", "Kittitas County", "Dauphin County", "Perry County",
    "Oglethorpe County", "Gogebic County", "Furnas County", "Maverick County",
    "Marshall County", "Wadena County", "Lunenburg County", "Pipestone County",
    "Rush County", "Arthur County", "Jefferson Davis Parish")
_STREET_NAMES = (
    "Main", "Oak", "Park", "First", "Second", "Third", "Fourth", "Fifth",
    "Sixth", "Seventh", "Eighth", "Ninth", "Tenth", "Elm", "Lake", "Hill",
    "Maple", "Pine", "Cedar", "Walnut", "Spring", "Sunset", "View",
    "Washington", "Lincoln", "Jackson", "Church", "Willow", "Ridge",
    "Meadow", "Forest", "River", "Highland", "Johnson", "Smith", "Green",
    "Wilson", "Dogwood", "Railroad", "Poplar", "Adams", "Center", "College",
    "Lee", "Laurel", "Mill", "Cherry", "Birch", "Davis", "Jefferson")
_STREET_TYPES = ("Street", "ST", "Ave", "Avenue", "Blvd", "Boulevard",
                 "Circle", "Cir.", "Court", "Ct.", "Drive", "Dr.", "Lane",
                 "Ln", "Parkway", "Pkwy", "Road", "RD", "Way", "Wy")
_LOCATION_TYPES = ("apartment", "condo", "single family")
_SALUTATIONS = ("Mr.", "Mrs.", "Ms.", "Miss", "Dr.", "Sir")
_FIRST_NAMES = (
    "James", "John", "Robert", "Michael", "William", "David", "Richard",
    "Charles", "Joseph", "Thomas", "Christopher", "Daniel", "Paul", "Mark",
    "Donald", "George", "Kenneth", "Steven", "Edward", "Brian", "Ronald",
    "Anthony", "Kevin", "Jason", "Matthew", "Gary", "Timothy", "Jose",
    "Larry", "Jeffrey", "Frank", "Scott", "Eric", "Stephen", "Andrew",
    "Mary", "Patricia", "Linda", "Barbara", "Elizabeth", "Jennifer",
    "Maria", "Susan", "Margaret", "Dorothy", "Lisa", "Nancy", "Karen",
    "Betty", "Helen", "Sandra", "Donna", "Carol", "Ruth", "Sharon",
    "Michelle", "Laura", "Sarah", "Kimberly", "Deborah", "Jessica",
    "Shirley", "Cynthia", "Angela", "Melissa", "Brenda", "Amy", "Anna",
    "Rebecca", "Virginia", "Kathleen", "Pamela", "Martha", "Debra")
_LAST_NAMES = (
    "Smith", "Johnson", "Williams", "Jones", "Brown", "Davis", "Miller",
    "Wilson", "Moore", "Taylor", "Anderson", "Thomas", "Jackson", "White",
    "Harris", "Martin", "Thompson", "Garcia", "Martinez", "Robinson",
    "Clark", "Rodriguez", "Lewis", "Lee", "Walker", "Hall", "Allen",
    "Young", "Hernandez", "King", "Wright", "Lopez", "Hill", "Scott",
    "Green", "Adams", "Baker", "Gonzalez", "Nelson", "Carter", "Mitchell",
    "Perez", "Roberts", "Turner", "Phillips", "Campbell", "Parker", "Evans",
    "Edwards", "Collins", "Stewart", "Sanchez", "Morris", "Rogers", "Reed",
    "Cook", "Morgan", "Bell", "Murphy", "Bailey", "Rivera", "Cooper",
    "Richardson", "Cox", "Howard", "Ward", "Torres", "Peterson", "Gray",
    "Ramirez", "James", "Watson", "Brooks", "Kelly", "Sanders", "Price",
    "Bennett", "Wood", "Barnes", "Ross", "Henderson", "Coleman", "Jenkins")
_COUNTRIES = ("UNITED STATES", "CANADA", "MEXICO", "GERMANY", "JAPAN",
              "FRANCE", "BRAZIL", "INDIA", "CHINA", "ITALY", "SPAIN",
              "RUSSIAN FEDERATION", "UNITED KINGDOM", "AUSTRALIA", "EGYPT",
              "NIGERIA", "ARGENTINA", "PERU", "CHILE", "NORWAY")
_REASONS = (
    "Package was damaged", "Stopped working", "Did not get it on time",
    "Not the product that was ordred", "Parts missing",
    "Does not work with a product that I have", "Gift exchange",
    "Did not like the color", "Did not like the model",
    "Did not like the make", "Did not like the warranty",
    "No service location in my area", "Found a better price in a store",
    "Found a better extended warranty in a store", "Not working any more",
    "Did not fit", "Wrong size", "Lost my job", "unauthoized purchase",
    "duplicate purchase", "its is a boy", "its is a girl")
_SHIP_TYPES = ("EXPRESS", "NEXT DAY", "OVERNIGHT", "REGULAR", "TWO DAY",
               "LIBRARY")
_SHIP_CODES = ("AIR", "SURFACE", "SEA", "BIKE", "HAND CARRY", "MESSENGER")
_CARRIERS = ("UPS", "FEDEX", "AIRBORNE", "USPS", "DHL", "TBS", "ZHOU",
             "ZOUROS", "MSC", "LATVIAN", "ALLIANCE", "ORIENTAL", "BARIAN",
             "BOXBUNDLES", "GREAT EASTERN", "DIAMOND", "RUPEKSA", "GERMA",
             "HARMSTORF", "PRIVATECARRIER")
_DAY_NAMES = ("Sunday", "Monday", "Tuesday", "Wednesday", "Thursday",
              "Friday", "Saturday")
_WORDS = ("furiously", "quickly", "carefully", "blithely", "slyly",
          "final", "regular", "express", "pending", "ironic", "special",
          "bold", "even", "silent", "unusual", "packages", "deposits",
          "accounts", "ideas", "theodolites", "instructions",
          "dependencies", "platelets", "asymptotes", "courts", "sleep",
          "wake", "haggle", "use", "boost", "detect", "integrate", "among",
          "across", "above", "along", "after", "about", "the", "of",
          "young", "old", "certain", "new", "good", "high", "small",
          "large", "national", "social", "important", "public", "able")


class _Pools:
    """Seeded pools for the columns no query reads: texts of given lengths
    and 16-character ids."""

    def __init__(self, rng, pa):
        self.rng, self.pa = rng, pa

    def texts(self, n: int, lo: int, hi: int, pool: int = 1024):
        rng = self.rng
        texts = []
        for length in rng.integers(lo, hi + 1, pool):
            words = []
            while len(" ".join(words)) < length:
                words.append(_WORDS[rng.integers(len(_WORDS))])
            texts.append(" ".join(words)[:length].strip() or "the")
        return self.pick(texts, rng.integers(0, pool, n))

    def pick(self, values, index):
        """`values[index]` as an arrow string array."""
        return self.pa.array(list(values)).take(
            self.pa.array(np.asarray(index, dtype=np.int64)))


def _ids(pa, numbers):
    """16-character business keys (`AAAAAAAA` and the number in base 16
    written with the letters A to P), as the specification's `*_id`."""
    numbers = np.asarray(numbers, dtype=np.int64)
    digits = [(numbers >> (4 * k)) & 15 for k in range(7, -1, -1)]
    codes = np.stack([d + ord("A") for d in digits], axis=1).astype(np.uint8)
    tail = codes.view("S8").reshape(-1)
    return pa.array(np.char.add(b"AAAAAAAA", tail).astype(str))


def _syllable_names(pa, numbers):
    """Names spelled with dsdgen's digit syllables (`able` 2, `ese` 4 ...),
    one syllable a decimal digit, as the specification's product, store
    and manufacturer names."""
    numbers = np.asarray(numbers, dtype=np.int64)
    out = np.full(len(numbers), "", dtype=object)
    rest = numbers.copy()
    first = True
    while first or (rest > 0).any():
        syl = np.array(_SYLLABLES, dtype=object)[rest % 10]
        keep = (rest > 0) | first
        out = np.where(keep, syl + out, out)
        rest = rest // 10
        first = False
    return pa.array(out.astype(str))


def _split(rng, total: int, lo: int, hi: int) -> np.ndarray:
    """Group sizes drawn from lo..hi that sum to `total` exactly (the last
    group is cut to fit)."""
    n = total // lo + 1
    sizes = rng.integers(lo, hi + 1, n)
    ends = np.cumsum(sizes)
    cut = int(np.searchsorted(ends, total))
    sizes = sizes[:cut + 1].copy()
    sizes[-1] -= int(ends[cut]) - total
    return sizes


def _coprime_stride(n: int) -> int:
    for p in (7919, 7907, 7901, 7883, 7879):
        if np.gcd(p, n) == 1:
            return p
    return 1


def _money(x):
    return np.round(x, 2)


def _pricing(rng, qty):
    """The sale's prices and amounts (the specification's pricing model:
    list price a markup over the wholesale cost, the sales price a
    discount under it, every extended amount the unit amount times the
    quantity)."""
    n = len(qty)
    wholesale = _money(rng.uniform(1.0, 100.0, n))
    list_price = _money(wholesale * (1.0 + rng.uniform(0.0, 2.0, n)))
    sales = _money(list_price * (1.0 - rng.uniform(0.0, 1.0, n)))
    ext_sales = _money(sales * qty)
    ext_wholesale = _money(wholesale * qty)
    ext_list = _money(list_price * qty)
    ext_tax = _money(ext_sales * rng.uniform(0.0, 0.09, n))
    coupon = _money(np.where(rng.random(n) < 0.2,
                             ext_sales * rng.uniform(0.0, 1.0, n), 0.0))
    net_paid = _money(ext_sales - coupon)
    return {
        "wholesale_cost": wholesale, "list_price": list_price,
        "sales_price": sales,
        "ext_discount_amt": _money((list_price - sales) * qty),
        "ext_sales_price": ext_sales, "ext_wholesale_cost": ext_wholesale,
        "ext_list_price": ext_list, "ext_tax": ext_tax,
        "coupon_amt": coupon, "net_paid": net_paid,
        "net_paid_inc_tax": _money(net_paid + ext_tax),
        "net_profit": _money(net_paid - ext_wholesale),
    }


def _returns(rng, sales_price, qty):
    """The amounts of a return of part of a sale."""
    n = len(qty)
    ret_qty = (1 + rng.integers(0, np.maximum(qty, 1))).astype(np.int64)
    amt = _money(sales_price * ret_qty)
    tax = _money(amt * rng.uniform(0.0, 0.09, n))
    inc_tax = _money(amt + tax)
    fee = _money(rng.uniform(0.5, 100.0, n))
    ship = _money(amt * rng.uniform(0.0, 0.5, n))
    cash = _money(inc_tax * rng.uniform(0.0, 1.0, n))
    charge = _money((inc_tax - cash) * rng.uniform(0.0, 1.0, n))
    credit = _money(inc_tax - cash - charge)
    return {"quantity": ret_qty, "amt": amt, "tax": tax, "inc_tax": inc_tax,
            "fee": fee, "ship_cost": ship, "cash": cash, "charge": charge,
            "credit": credit, "net_loss": _money(tax + fee + ship)}


def _date_dim(pa, pools, n: int) -> dict:
    first = _FIRST_DAY.toordinal()
    ordinal = np.arange(first, first + n, dtype=np.int64)
    days = (ordinal - _EPOCH_ORDINAL).astype("datetime64[D]")
    year = days.astype("datetime64[Y]").astype(np.int64) + 1970
    month_start = days.astype("datetime64[M]")
    moy = month_start.astype(np.int64) % 12 + 1
    dom = (days - month_start).astype(np.int64) + 1
    dow = (ordinal - _EPOCH_ORDINAL + 4) % 7          # 1970-01-01: Thursday
    qoy = (moy - 1) // 3 + 1
    sk = ordinal + _JD_OFFSET
    next_month = (month_start + np.timedelta64(1, "M")).astype(
        "datetime64[D]").astype(np.int64) + _EPOCH_ORDINAL + _JD_OFFSET
    first_dom = month_start.astype("datetime64[D]").astype(
        np.int64) + _EPOCH_ORDINAL + _JD_OFFSET
    week_seq = (ordinal - datetime.date(1899, 12, 31).toordinal()) // 7 + 1
    quarter_seq = (year - 1900) * 4 + qoy
    holiday = (((moy == 1) & (dom == 1)) | ((moy == 7) & (dom == 4))
               | ((moy == 12) & (dom == 25)))
    yn = np.array(["N", "Y"])
    return {
        "d_date_sk": sk,
        "d_date_id": _ids(pa, sk),
        "d_date": pa.array(ordinal - _EPOCH_ORDINAL, type=pa.int32()).cast(
            pa.date32()),
        "d_month_seq": (year - 1900) * 12 + moy - 1,
        "d_week_seq": week_seq,
        "d_quarter_seq": quarter_seq,
        "d_year": year,
        "d_dow": dow,
        "d_moy": moy,
        "d_dom": dom,
        "d_qoy": qoy,
        "d_fy_year": year,
        "d_fy_quarter_seq": quarter_seq,
        "d_fy_week_seq": week_seq,
        "d_day_name": pools.pick(_DAY_NAMES, dow),
        "d_quarter_name": pa.array(np.char.add(
            np.char.add(year.astype(str), "Q"), qoy.astype(str))),
        "d_holiday": yn[holiday.astype(int)],
        "d_weekend": yn[((dow == 0) | (dow == 6)).astype(int)],
        "d_following_holiday": yn[np.concatenate(
            [[0], holiday[:-1].astype(int)])],
        "d_first_dom": first_dom,
        "d_last_dom": next_month - 1,
        "d_same_day_ly": sk - 365,
        "d_same_day_lq": sk - 91,
        "d_current_day": np.full(n, "N"),
        "d_current_week": np.full(n, "N"),
        "d_current_month": np.full(n, "N"),
        "d_current_quarter": np.full(n, "N"),
        "d_current_year": np.full(n, "N"),
    }


def _time_dim(pa, pools, n: int) -> dict:
    sk = np.arange(n, dtype=np.int64)
    hour, minute, second = sk // 3600, (sk // 60) % 60, sk % 60
    meal = np.select([(hour >= 6) & (hour < 9), (hour >= 11) & (hour < 14),
                      (hour >= 17) & (hour < 21)], [0, 1, 2], 3)
    shift = np.select([hour < 8, hour < 16], [2, 0], 1)
    sub = np.select([hour < 6, hour < 12, hour < 18], [3, 0, 1], 2)
    return {
        "t_time_sk": sk,
        "t_time_id": _ids(pa, sk),
        "t_time": sk,
        "t_hour": hour,
        "t_minute": minute,
        "t_second": second,
        "t_am_pm": np.where(hour < 12, "AM", "PM"),
        "t_shift": pools.pick(("first", "second", "third"), shift),
        "t_sub_shift": pools.pick(("morning", "afternoon", "evening",
                                   "night"), sub),
        "t_meal_time": pa.array(np.array(["breakfast", "lunch", "dinner",
                                          ""], dtype=object)[meal],
                                mask=meal == 3),
    }


def _scd_dates(pa, rev, nrev):
    """Record start and end dates of revision `rev` of `nrev` (the
    specification's slowly changing dimensions: one, two or three
    revisions; the current one has no end date)."""
    bounds = {1: [(1997, 10, 27)],
              2: [(1997, 10, 27), (2000, 10, 27)],
              3: [(1997, 10, 27), (1999, 10, 28), (2001, 10, 27)]}
    start = np.zeros(len(rev), dtype=np.int32)
    end = np.zeros(len(rev), dtype=np.int32)
    for k, days in bounds.items():
        for i, d in enumerate(days):
            m = (nrev == k) & (rev == i)
            start[m] = datetime.date(*d).toordinal() - _EPOCH_ORDINAL
            if i + 1 < len(days):
                end[m] = (datetime.date(*days[i + 1]).toordinal()
                          - _EPOCH_ORDINAL - 1)
    current = rev == nrev - 1
    return (pa.array(start).cast(pa.date32()),
            pa.array(end, mask=current).cast(pa.date32()))


def _revisions(n_rows: int):
    """(id index, revision, revisions of the id) of each row: ids with
    one, two and three revisions in turn."""
    pattern = np.array([1, 2, 2, 3, 3, 3])
    nrev = np.resize(pattern, n_rows)
    group = np.arange(n_rows) // 6
    within = np.resize(np.array([0, 0, 1, 0, 1, 2]), n_rows)
    first_id = np.resize(np.array([0, 1, 1, 2, 2, 2]), n_rows)
    return group * 3 + first_id, within, nrev


def generate(out_dir: str, scale: float = 1.0,
             seed: int = 20261018) -> Dict[str, str]:
    """Write the 24 tables as parquet dirs under `out_dir`; returns
    {table: path}. Idempotent for a given (out_dir, scale, seed)."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    rows = row_counts(scale)
    rng = np.random.default_rng(seed)
    pools = _Pools(np.random.default_rng([seed, 7]), pa)
    sales_lo, sales_hi = jd(_SALES_FIRST), jd(_SALES_LAST)
    n_item, n_cust = rows["item"], rows["customer"]
    n_addr, n_cd, n_hd = (rows["customer_address"],
                          rows["customer_demographics"],
                          rows["household_demographics"])
    n_store, n_promo = rows["store"], rows["promotion"]
    n_wh, n_cc, n_cp = rows["warehouse"], rows["call_center"], \
        rows["catalog_page"]
    n_web, n_wp, n_sm = rows["web_site"], rows["web_page"], rows["ship_mode"]
    n_reason = rows["reason"]

    def keys(n_rows, n_domain):
        return rng.integers(1, n_domain + 1, n_rows).astype(np.int64)

    def nullable(values):
        return pa.array(values, mask=rng.random(len(values)) < _NULL_SHARE)

    tables: Dict[str, dict] = {}
    tables["date_dim"] = _date_dim(pa, pools, rows["date_dim"])
    tables["time_dim"] = _time_dim(pa, pools, rows["time_dim"])

    # -- item ------------------------------------------------------------
    item_id, rev, nrev = _revisions(n_item)
    n_item_ids = int(item_id.max()) + 1
    cat = rng.integers(0, len(_CATEGORIES), n_item_ids)[item_id]
    n_class = np.array([len(_CLASSES[c]) for c in _CATEGORIES])[cat]
    cls = (rng.random(n_item_ids)[item_id] * n_class).astype(np.int64)
    brand = 1 + rng.integers(0, _BRANDS_PER_CLASS, n_item_ids)[item_id]
    class_names = [k for c in _CATEGORIES for k in _CLASSES[c]]
    class_offset = np.cumsum([0] + [len(_CLASSES[c]) for c in _CATEGORIES])
    manufact = rng.integers(1, 1001, n_item)
    start, end = _scd_dates(pa, rev, nrev)
    price = _money(rng.uniform(0.09, 99.99, n_item))
    tables["item"] = {
        "i_item_sk": np.arange(1, n_item + 1, dtype=np.int64),
        "i_item_id": _ids(pa, item_id),
        "i_rec_start_date": start,
        "i_rec_end_date": end,
        "i_item_desc": pools.texts(n_item, 1, 200),
        "i_current_price": price,
        "i_wholesale_cost": _money(price * rng.uniform(0.3, 0.9, n_item)),
        "i_brand_id": ((cat + 1) * 1_000_000 + (cls + 1) * 1000
                       + brand).astype(np.int64),
        "i_brand": pa.array(np.char.add(
            "brand_", np.char.zfill(brand.astype(str), 2))),
        "i_class_id": (cls + 1).astype(np.int64),
        "i_class": pools.pick(class_names,
                              class_offset[cat] + cls),
        "i_category_id": (cat + 1).astype(np.int64),
        "i_category": pools.pick(_CATEGORIES, cat),
        "i_manufact_id": manufact.astype(np.int64),
        "i_manufact": _syllable_names(pa, manufact),
        "i_size": pools.pick(_SIZES, rng.integers(0, len(_SIZES), n_item)),
        "i_formulation": pools.texts(n_item, 20, 20),
        "i_color": pools.pick(_COLORS, rng.integers(0, len(_COLORS), n_item)),
        "i_units": pools.pick(_UNITS, rng.integers(0, len(_UNITS), n_item)),
        "i_container": np.full(n_item, "Unknown"),
        "i_manager_id": rng.integers(1, 101, n_item).astype(np.int64),
        "i_product_name": _syllable_names(pa, item_id + 1),
    }

    # -- demographics, income bands, addresses, customers -----------------
    i = np.arange(n_cd, dtype=np.int64)
    radix = [2, 5, 7, 20, 4, 7, 7, 7]
    digit, rest = [], i
    for r in radix:
        digit.append(rest % r)
        rest = rest // r
    tables["customer_demographics"] = {
        "cd_demo_sk": i + 1,
        "cd_gender": pools.pick(_GENDERS, digit[0]),
        "cd_marital_status": pools.pick(_MARITAL, digit[1]),
        "cd_education_status": pools.pick(_EDUCATION, digit[2]),
        "cd_purchase_estimate": (500 * (digit[3] + 1)).astype(np.int64),
        "cd_credit_rating": pools.pick(_CREDIT, digit[4]),
        "cd_dep_count": digit[5],
        "cd_dep_employed_count": digit[6],
        "cd_dep_college_count": digit[7],
    }
    i = np.arange(n_hd, dtype=np.int64)
    tables["household_demographics"] = {
        "hd_demo_sk": i + 1,
        "hd_income_band_sk": i % 20 + 1,
        "hd_buy_potential": pools.pick(_BUY_POTENTIAL, (i // 20) % 6),
        "hd_dep_count": (i // 120) % 10,
        "hd_vehicle_count": (i // 1200) % 6 - 1,
    }
    tables["income_band"] = {
        "ib_income_band_sk": np.arange(1, 21, dtype=np.int64),
        "ib_lower_bound": np.concatenate(
            [[0], np.arange(1, 20) * 10000 + 1]).astype(np.int64),
        "ib_upper_bound": (np.arange(1, 21) * 10000).astype(np.int64),
    }
    weights = np.array([w for _, w, _ in _STATES], dtype=float)
    state = rng.choice(len(_STATES), n_addr, p=weights / weights.sum())
    city_w = 1.0 / np.arange(1, len(_CITIES) + 1) ** 0.8
    tables["customer_address"] = {
        "ca_address_sk": np.arange(1, n_addr + 1, dtype=np.int64),
        "ca_address_id": _ids(pa, np.arange(n_addr)),
        "ca_street_number": rng.integers(1, 1001, n_addr).astype(str),
        "ca_street_name": pools.pick(
            _STREET_NAMES, rng.integers(0, len(_STREET_NAMES), n_addr)),
        "ca_street_type": pools.pick(
            _STREET_TYPES, rng.integers(0, len(_STREET_TYPES), n_addr)),
        "ca_suite_number": np.char.add(
            "Suite ", (rng.integers(0, 50, n_addr) * 10).astype(str)),
        "ca_city": pools.pick(_CITIES, rng.choice(
            len(_CITIES), n_addr, p=city_w / city_w.sum())),
        "ca_county": pools.pick(_COUNTIES,
                                rng.integers(0, len(_COUNTIES), n_addr)),
        "ca_state": pools.pick([s for s, _, _ in _STATES], state),
        "ca_zip": np.char.zfill(rng.integers(601, 99951, n_addr).astype(str),
                                5),
        "ca_country": np.full(n_addr, "United States"),
        "ca_gmt_offset": np.array([g for _, _, g in _STATES],
                                  dtype=np.float64)[state],
        "ca_location_type": pools.pick(
            _LOCATION_TYPES, rng.integers(0, len(_LOCATION_TYPES), n_addr)),
    }
    first = rng.integers(0, len(_FIRST_NAMES), n_cust)
    last = rng.integers(0, len(_LAST_NAMES), n_cust)
    first_sales = rng.integers(sales_lo - 3650, sales_hi + 1, n_cust)
    c_id = _ids(pa, np.arange(n_cust))
    tables["customer"] = {
        "c_customer_sk": np.arange(1, n_cust + 1, dtype=np.int64),
        "c_customer_id": c_id,
        "c_current_cdemo_sk": keys(n_cust, n_cd),
        "c_current_hdemo_sk": keys(n_cust, n_hd),
        "c_current_addr_sk": keys(n_cust, n_addr),
        "c_first_shipto_date_sk": (first_sales
                                   + rng.integers(0, 31, n_cust)).astype(
            np.int64),
        "c_first_sales_date_sk": first_sales.astype(np.int64),
        "c_salutation": pools.pick(_SALUTATIONS, rng.integers(
            0, len(_SALUTATIONS), n_cust)),
        "c_first_name": pools.pick(_FIRST_NAMES, first),
        "c_last_name": pools.pick(_LAST_NAMES, last),
        "c_preferred_cust_flag": np.where(rng.random(n_cust) < 0.5, "Y",
                                          "N"),
        "c_birth_day": rng.integers(1, 29, n_cust).astype(np.int64),
        "c_birth_month": rng.integers(1, 13, n_cust).astype(np.int64),
        "c_birth_year": rng.integers(1924, 1993, n_cust).astype(np.int64),
        "c_birth_country": pools.pick(_COUNTRIES, rng.integers(
            0, len(_COUNTRIES), n_cust)),
        "c_login": pa.nulls(n_cust, pa.string()),
        "c_email_address": np.char.add(np.char.add(np.char.add(
            np.array(_FIRST_NAMES)[first], "."), np.array(_LAST_NAMES)[last]),
            np.char.add("@", np.array(c_id.to_pylist(), dtype=str))),
        "c_last_review_date_sk": rng.integers(sales_hi - 365, sales_hi + 1,
                                              n_cust).astype(np.int64),
    }

    # -- the smaller dimensions --------------------------------------------
    store_id, srev, snrev = _revisions(n_store)
    s_start, s_end = _scd_dates(pa, srev, snrev)
    tables["store"] = {
        "s_store_sk": np.arange(1, n_store + 1, dtype=np.int64),
        "s_store_id": _ids(pa, store_id),
        "s_rec_start_date": s_start,
        "s_rec_end_date": s_end,
        "s_closed_date_sk": pa.array(
            rng.integers(sales_lo, sales_hi, n_store),
            mask=rng.random(n_store) < 0.8),
        "s_store_name": _syllable_names(pa, store_id + 1),
        "s_number_employees": rng.integers(200, 301, n_store).astype(
            np.int64),
        "s_floor_space": rng.integers(5_000_000, 10_000_001,
                                      n_store).astype(np.int64),
        "s_hours": pools.pick(("8AM-4PM", "8AM-12AM", "8AM-8AM"),
                              rng.integers(0, 3, n_store)),
        "s_manager": pools.pick(_FIRST_NAMES, rng.integers(
            0, len(_FIRST_NAMES), n_store)),
        "s_market_id": rng.integers(1, 11, n_store).astype(np.int64),
        "s_geography_class": np.full(n_store, "Unknown"),
        "s_market_desc": pools.texts(n_store, 20, 100),
        "s_market_manager": pools.pick(_LAST_NAMES, rng.integers(
            0, len(_LAST_NAMES), n_store)),
        "s_division_id": np.ones(n_store, dtype=np.int64),
        "s_division_name": np.full(n_store, "Unknown"),
        "s_company_id": np.ones(n_store, dtype=np.int64),
        "s_company_name": np.full(n_store, "Unknown"),
        "s_street_number": rng.integers(1, 1001, n_store).astype(str),
        "s_street_name": pools.pick(_STREET_NAMES, rng.integers(
            0, len(_STREET_NAMES), n_store)),
        "s_street_type": pools.pick(_STREET_TYPES, rng.integers(
            0, len(_STREET_TYPES), n_store)),
        "s_suite_number": np.char.add(
            "Suite ", (rng.integers(0, 50, n_store) * 10).astype(str)),
        "s_city": pools.pick(("Midway", "Fairview"),
                             rng.integers(0, 2, n_store)),
        "s_county": np.full(n_store, "Williamson County"),
        "s_state": np.full(n_store, "TN"),
        "s_zip": np.char.zfill(rng.integers(30000, 40000,
                                            n_store).astype(str), 5),
        "s_country": np.full(n_store, "United States"),
        "s_gmt_offset": np.full(n_store, -5.0),
        "s_tax_precentage": _money(rng.uniform(0.0, 0.11, n_store)),
    }
    p_start = rng.integers(sales_lo, sales_hi, n_promo).astype(np.int64)
    tables["promotion"] = {
        "p_promo_sk": np.arange(1, n_promo + 1, dtype=np.int64),
        "p_promo_id": _ids(pa, np.arange(n_promo)),
        "p_start_date_sk": p_start,
        "p_end_date_sk": p_start + rng.integers(30, 120, n_promo),
        "p_item_sk": keys(n_promo, n_item),
        "p_cost": np.full(n_promo, 1000.0),
        "p_response_target": np.ones(n_promo, dtype=np.int64),
        "p_promo_name": _syllable_names(pa, rng.integers(0, 10, n_promo)),
        "p_channel_dmail": np.where(rng.random(n_promo) < 0.5, "Y", "N"),
        "p_channel_email": np.where(rng.random(n_promo) < 0.1, "Y", "N"),
        "p_channel_catalog": np.where(rng.random(n_promo) < 0.1, "Y", "N"),
        "p_channel_tv": np.where(rng.random(n_promo) < 0.5, "Y", "N"),
        "p_channel_radio": np.where(rng.random(n_promo) < 0.1, "Y", "N"),
        "p_channel_press": np.where(rng.random(n_promo) < 0.1, "Y", "N"),
        "p_channel_event": np.where(rng.random(n_promo) < 0.1, "Y", "N"),
        "p_channel_demo": np.where(rng.random(n_promo) < 0.1, "Y", "N"),
        "p_channel_details": pools.texts(n_promo, 20, 60),
        "p_purpose": np.full(n_promo, "Unknown"),
        "p_discount_active": np.where(rng.random(n_promo) < 0.1, "Y", "N"),
    }
    tables["reason"] = {
        "r_reason_sk": np.arange(1, n_reason + 1, dtype=np.int64),
        "r_reason_id": _ids(pa, np.arange(n_reason)),
        "r_reason_desc": pa.array(
            [_REASONS[k] if k < len(_REASONS) else f"reason {k + 1}"
             for k in range(n_reason)]),
    }
    tables["ship_mode"] = {
        "sm_ship_mode_sk": np.arange(1, n_sm + 1, dtype=np.int64),
        "sm_ship_mode_id": _ids(pa, np.arange(n_sm)),
        "sm_type": pools.pick(_SHIP_TYPES, np.arange(n_sm) % 6),
        "sm_code": pools.pick(_SHIP_CODES, (np.arange(n_sm) // 6) % 6),
        "sm_carrier": pools.pick(_CARRIERS, np.arange(n_sm) % 20),
        "sm_contract": pools.texts(n_sm, 1, 20),
    }

    def site(prefix, n, names):
        """Address columns of a warehouse, web site or call center."""
        st = rng.choice(len(_STATES), n, p=weights / weights.sum())
        return {
            f"{prefix}street_number": rng.integers(1, 1001, n).astype(str),
            f"{prefix}street_name": pools.pick(_STREET_NAMES, rng.integers(
                0, len(_STREET_NAMES), n)),
            f"{prefix}street_type": pools.pick(_STREET_TYPES, rng.integers(
                0, len(_STREET_TYPES), n)),
            f"{prefix}suite_number": np.char.add(
                "Suite ", (rng.integers(0, 50, n) * 10).astype(str)),
            f"{prefix}city": pools.pick(names, rng.integers(0, len(names),
                                                            n)),
            f"{prefix}county": pools.pick(_COUNTIES, rng.integers(
                0, len(_COUNTIES), n)),
            f"{prefix}state": pools.pick([s for s, _, _ in _STATES], st),
            f"{prefix}zip": np.char.zfill(rng.integers(601, 99951, n).astype(
                str), 5),
            f"{prefix}country": np.full(n, "United States"),
            f"{prefix}gmt_offset": np.array([g for _, _, g in _STATES],
                                            dtype=np.float64)[st],
        }

    wh = {"w_warehouse_sk": np.arange(1, n_wh + 1, dtype=np.int64),
          "w_warehouse_id": _ids(pa, np.arange(n_wh)),
          "w_warehouse_name": pools.texts(n_wh, 10, 20),
          "w_warehouse_sq_ft": rng.integers(50_000, 1_000_001,
                                            n_wh).astype(np.int64)}
    wh.update(site("w_", n_wh, _CITIES[:20]))
    tables["warehouse"] = wh
    web_id, wrev, wnrev = _revisions(n_web)
    w_start, w_end = _scd_dates(pa, wrev, wnrev)
    ws_site = {
        "web_site_sk": np.arange(1, n_web + 1, dtype=np.int64),
        "web_site_id": _ids(pa, web_id),
        "web_rec_start_date": w_start,
        "web_rec_end_date": w_end,
        "web_name": pa.array([f"site_{k}" for k in web_id]),
        "web_open_date_sk": rng.integers(sales_lo - 2000, sales_lo,
                                         n_web).astype(np.int64),
        "web_close_date_sk": pa.array(rng.integers(sales_lo, sales_hi,
                                                   n_web),
                                      mask=rng.random(n_web) < 0.8),
        "web_class": np.full(n_web, "Unknown"),
        "web_manager": pools.pick(_FIRST_NAMES, rng.integers(
            0, len(_FIRST_NAMES), n_web)),
        "web_mkt_id": rng.integers(1, 7, n_web).astype(np.int64),
        "web_mkt_class": pools.texts(n_web, 10, 40),
        "web_mkt_desc": pools.texts(n_web, 20, 100),
        "web_market_manager": pools.pick(_LAST_NAMES, rng.integers(
            0, len(_LAST_NAMES), n_web)),
        "web_company_id": rng.integers(1, 7, n_web).astype(np.int64),
        "web_company_name": _syllable_names(pa, rng.integers(1, 7, n_web)),
    }
    ws_site.update({("web_" + k[2:]): v
                    for k, v in site("w_", n_web, _CITIES[:30]).items()})
    ws_site["web_tax_percentage"] = _money(rng.uniform(0.0, 0.12, n_web))
    tables["web_site"] = ws_site
    wp_id, prev, pnrev = _revisions(n_wp)
    p_start, p_end = _scd_dates(pa, prev, pnrev)
    tables["web_page"] = {
        "wp_web_page_sk": np.arange(1, n_wp + 1, dtype=np.int64),
        "wp_web_page_id": _ids(pa, wp_id),
        "wp_rec_start_date": p_start,
        "wp_rec_end_date": p_end,
        "wp_creation_date_sk": rng.integers(sales_lo - 1000, sales_lo,
                                            n_wp).astype(np.int64),
        "wp_access_date_sk": rng.integers(sales_hi - 100, sales_hi,
                                          n_wp).astype(np.int64),
        "wp_autogen_flag": np.where(rng.random(n_wp) < 0.5, "Y", "N"),
        "wp_customer_sk": pa.array(keys(n_wp, n_cust),
                                   mask=rng.random(n_wp) < 0.7),
        "wp_url": np.full(n_wp, "http://www.foo.com"),
        "wp_type": pools.pick(("welcome", "protected", "general", "dynamic",
                               "feedback", "order", "ad"),
                              rng.integers(0, 7, n_wp)),
        "wp_char_count": rng.integers(300, 8000, n_wp).astype(np.int64),
        "wp_link_count": rng.integers(2, 26, n_wp).astype(np.int64),
        "wp_image_count": rng.integers(1, 8, n_wp).astype(np.int64),
        "wp_max_ad_count": rng.integers(0, 5, n_wp).astype(np.int64),
    }
    cc_id, crev, cnrev = _revisions(n_cc)
    c_start, c_end = _scd_dates(pa, crev, cnrev)
    cc = {
        "cc_call_center_sk": np.arange(1, n_cc + 1, dtype=np.int64),
        "cc_call_center_id": _ids(pa, cc_id),
        "cc_rec_start_date": c_start,
        "cc_rec_end_date": c_end,
        "cc_closed_date_sk": pa.nulls(n_cc, pa.int64()),
        "cc_open_date_sk": rng.integers(sales_lo - 3000, sales_lo,
                                        n_cc).astype(np.int64),
        "cc_name": pools.pick(("NY Metro", "Mid Atlantic", "North Midwest",
                               "Pacific Northwest", "California",
                               "Hawaii/Alaska"), cc_id % 6),
        "cc_class": pools.pick(("small", "medium", "large"),
                               rng.integers(0, 3, n_cc)),
        "cc_employees": rng.integers(1, 7000, n_cc).astype(np.int64),
        "cc_sq_ft": rng.integers(1000, 700_000, n_cc).astype(np.int64),
        "cc_hours": pools.pick(("8AM-4PM", "8AM-12AM", "8AM-8AM"),
                               rng.integers(0, 3, n_cc)),
        "cc_manager": pools.pick(_FIRST_NAMES, rng.integers(
            0, len(_FIRST_NAMES), n_cc)),
        "cc_mkt_id": rng.integers(1, 7, n_cc).astype(np.int64),
        "cc_mkt_class": pools.texts(n_cc, 10, 40),
        "cc_mkt_desc": pools.texts(n_cc, 20, 100),
        "cc_market_manager": pools.pick(_LAST_NAMES, rng.integers(
            0, len(_LAST_NAMES), n_cc)),
        "cc_division": rng.integers(1, 7, n_cc).astype(np.int64),
        "cc_division_name": _syllable_names(pa, rng.integers(1, 7, n_cc)),
        "cc_company": rng.integers(1, 7, n_cc).astype(np.int64),
        "cc_company_name": _syllable_names(pa, rng.integers(1, 7, n_cc)),
    }
    cc.update({("cc_" + k[2:]): v
               for k, v in site("w_", n_cc, _CITIES[:10]).items()})
    cc["cc_tax_percentage"] = _money(rng.uniform(0.0, 0.12, n_cc))
    tables["call_center"] = cc
    cp = np.arange(n_cp, dtype=np.int64)
    cp_start = sales_lo - 365 + (cp // 108) * 30
    tables["catalog_page"] = {
        "cp_catalog_page_sk": cp + 1,
        "cp_catalog_page_id": _ids(pa, cp),
        "cp_start_date_sk": cp_start,
        "cp_end_date_sk": cp_start + 89,
        "cp_department": np.full(n_cp, "DEPARTMENT"),
        "cp_catalog_number": cp // 108 + 1,
        "cp_catalog_page_number": cp % 108 + 1,
        "cp_description": pools.texts(n_cp, 20, 100),
        "cp_type": pools.pick(("bi-annual", "quarterly", "monthly"),
                              (cp // 108) % 3),
    }

    # -- store_sales: tickets of several line items -------------------------
    n_ss = rows["store_sales"]
    sizes = _split(rng, n_ss, *_TICKET_LINES)
    n_tick = len(sizes)
    tick = np.repeat(np.arange(n_tick, dtype=np.int64), sizes)
    pos = np.arange(n_ss, dtype=np.int64) - np.repeat(
        np.cumsum(sizes) - sizes, sizes)
    stride = _coprime_stride(n_item)
    t_base = rng.integers(0, n_item, n_tick)
    t_date = rng.integers(sales_lo, sales_hi + 1, n_tick)
    t_cust = keys(n_tick, n_cust)
    t_store = keys(n_tick, n_store)
    ss_item = 1 + (t_base[tick] + pos * stride) % n_item
    ss_qty = rng.integers(1, 101, n_ss).astype(np.int64)
    price = _pricing(rng, ss_qty)
    ss = {
        "ss_sold_date_sk": t_date[tick],
        "ss_sold_time_sk": rng.integers(8 * 3600, 21 * 3600,
                                        n_tick)[tick].astype(np.int64),
        "ss_item_sk": ss_item,
        "ss_customer_sk": t_cust[tick],
        "ss_cdemo_sk": keys(n_tick, n_cd)[tick],
        "ss_hdemo_sk": keys(n_tick, n_hd)[tick],
        "ss_addr_sk": keys(n_tick, n_addr)[tick],
        "ss_store_sk": nullable(t_store[tick]),
        "ss_promo_sk": keys(n_ss, n_promo),
        "ss_ticket_number": tick + 1,
        "ss_quantity": ss_qty,
    }
    ss.update({"ss_" + k: v for k, v in price.items()})
    tables["store_sales"] = ss

    # -- store_returns: drawn from store sales rows -------------------------
    n_sr = rows["store_returns"]
    pick = np.sort(rng.permutation(n_ss)[:n_sr])
    ret = _returns(rng, price["sales_price"][pick], ss_qty[pick])
    sr_date = ss["ss_sold_date_sk"][pick] + rng.integers(
        _RETURN_LAG[0], _RETURN_LAG[1] + 1, n_sr)
    tables["store_returns"] = {
        "sr_returned_date_sk": sr_date.astype(np.int64),
        "sr_return_time_sk": rng.integers(8 * 3600, 21 * 3600,
                                          n_sr).astype(np.int64),
        "sr_item_sk": ss_item[pick],
        "sr_customer_sk": ss["ss_customer_sk"][pick],
        "sr_cdemo_sk": ss["ss_cdemo_sk"][pick],
        "sr_hdemo_sk": ss["ss_hdemo_sk"][pick],
        "sr_addr_sk": ss["ss_addr_sk"][pick],
        "sr_store_sk": t_store[tick][pick],
        "sr_reason_sk": keys(n_sr, n_reason),
        "sr_ticket_number": ss["ss_ticket_number"][pick],
        "sr_return_quantity": ret["quantity"],
        "sr_return_amt": ret["amt"],
        "sr_return_tax": ret["tax"],
        "sr_return_amt_inc_tax": ret["inc_tax"],
        "sr_fee": ret["fee"],
        "sr_return_ship_cost": ret["ship_cost"],
        "sr_refunded_cash": ret["cash"],
        "sr_reversed_charge": ret["charge"],
        "sr_store_credit": ret["credit"],
        "sr_net_loss": ret["net_loss"],
    }

    # -- catalog and web sales: orders of several line items ------------------
    def orders(channel, n_rows, follow_share):
        """(order of each row, item of each row, and each order's bill
        customer and sold date) of a channel's sales. An order that
        follows a store visit is billed to the visit's customer, 1 to 120
        days after it, and buys the visit's items again first."""
        sizes = _split(rng, n_rows, *_ORDER_LINES[channel])
        n_ord = len(sizes)
        order = np.repeat(np.arange(n_ord, dtype=np.int64), sizes)
        line = np.arange(n_rows, dtype=np.int64) - np.repeat(
            np.cumsum(sizes) - sizes, sizes)
        follows = rng.random(n_ord) < follow_share
        visit = rng.integers(0, n_tick, n_ord)
        base = np.where(follows, t_base[visit], rng.integers(0, n_item,
                                                             n_ord))
        cust = np.where(follows, t_cust[visit], keys(n_ord, n_cust))
        date = np.where(follows, t_date[visit] + rng.integers(1, 121, n_ord),
                        rng.integers(sales_lo, sales_hi + 1, n_ord))
        date = np.minimum(date, sales_hi)
        item = 1 + (base[order] + line * stride) % n_item
        return order, item, cust, date

    def channel_sales(prefix, n_rows, follow_share, extra):
        order, item, o_cust, o_date = orders(
            "catalog" if prefix == "cs_" else "web", n_rows, follow_share)
        n_ord = len(o_cust)
        date = o_date[order]
        qty = rng.integers(1, 101, n_rows).astype(np.int64)
        p = _pricing(rng, qty)
        ship_cost = _money(p["ext_list_price"] * rng.uniform(0.0, 0.5,
                                                             n_rows))
        o_cdemo, o_hdemo, o_addr = (keys(n_ord, n_cd), keys(n_ord, n_hd),
                                    keys(n_ord, n_addr))
        same = rng.random(n_ord) < 0.9
        ship_cust = np.where(same, o_cust, keys(n_ord, n_cust))
        out = {
            f"{prefix}sold_date_sk": date.astype(np.int64),
            f"{prefix}sold_time_sk": rng.integers(0, 86400,
                                                  n_ord)[order].astype(
                np.int64),
            f"{prefix}ship_date_sk": (date + rng.integers(
                2, 91, n_ord)[order]).astype(np.int64),
            f"{prefix}bill_customer_sk": o_cust[order].astype(np.int64),
            f"{prefix}bill_cdemo_sk": o_cdemo[order],
            f"{prefix}bill_hdemo_sk": o_hdemo[order],
            f"{prefix}bill_addr_sk": o_addr[order],
            f"{prefix}ship_customer_sk": ship_cust[order],
            f"{prefix}ship_cdemo_sk": np.where(same, o_cdemo, keys(
                n_ord, n_cd))[order],
            f"{prefix}ship_hdemo_sk": np.where(same, o_hdemo, keys(
                n_ord, n_hd))[order],
            f"{prefix}ship_addr_sk": np.where(same, o_addr, keys(
                n_ord, n_addr))[order],
        }
        out.update(extra(n_rows, n_ord, order))
        out.update({
            f"{prefix}item_sk": item.astype(np.int64),
            f"{prefix}promo_sk": keys(n_rows, n_promo),
            f"{prefix}order_number": order + 1,
            f"{prefix}quantity": qty,
            f"{prefix}wholesale_cost": p["wholesale_cost"],
            f"{prefix}list_price": p["list_price"],
            f"{prefix}sales_price": p["sales_price"],
            f"{prefix}ext_discount_amt": p["ext_discount_amt"],
            f"{prefix}ext_sales_price": p["ext_sales_price"],
            f"{prefix}ext_wholesale_cost": p["ext_wholesale_cost"],
            f"{prefix}ext_list_price": p["ext_list_price"],
            f"{prefix}ext_tax": p["ext_tax"],
            f"{prefix}coupon_amt": p["coupon_amt"],
            f"{prefix}ext_ship_cost": ship_cost,
            f"{prefix}net_paid": p["net_paid"],
            f"{prefix}net_paid_inc_tax": p["net_paid_inc_tax"],
            f"{prefix}net_paid_inc_ship": _money(p["net_paid"] + ship_cost),
            f"{prefix}net_paid_inc_ship_tax": _money(
                p["net_paid_inc_tax"] + ship_cost),
            f"{prefix}net_profit": p["net_profit"],
        })
        return out, p, qty

    def catalog_extra(n_rows, n_ord, order):
        return {
            "cs_call_center_sk": keys(n_ord, n_cc)[order],
            "cs_catalog_page_sk": keys(n_rows, n_cp),
            "cs_ship_mode_sk": keys(n_ord, n_sm)[order],
            "cs_warehouse_sk": keys(n_rows, n_wh),
        }

    def web_extra(n_rows, n_ord, order):
        return {
            "ws_web_page_sk": keys(n_rows, n_wp),
            "ws_web_site_sk": keys(n_ord, n_web)[order],
            "ws_ship_mode_sk": keys(n_ord, n_sm)[order],
            "ws_warehouse_sk": keys(n_rows, n_wh),
        }

    cs, cs_p, cs_qty = channel_sales("cs_", rows["catalog_sales"],
                                     _FOLLOW_SHARE, catalog_extra)
    cs["cs_ship_addr_sk"] = nullable(cs["cs_ship_addr_sk"])
    tables["catalog_sales"] = cs
    ws, ws_p, ws_qty = channel_sales("ws_", rows["web_sales"], 0.0,
                                     web_extra)
    ws["ws_ship_customer_sk"] = nullable(ws["ws_ship_customer_sk"])
    tables["web_sales"] = ws

    # -- catalog and web returns: drawn from their sales rows -----------------
    n_cr = rows["catalog_returns"]
    pick = np.sort(rng.permutation(len(cs_qty))[:n_cr])
    ret = _returns(rng, cs_p["sales_price"][pick], cs_qty[pick])
    cr_date = cs["cs_ship_date_sk"][pick] + rng.integers(
        _RETURN_LAG[0], _RETURN_LAG[1] + 1, n_cr)
    tables["catalog_returns"] = {
        "cr_returned_date_sk": cr_date.astype(np.int64),
        "cr_returned_time_sk": rng.integers(0, 86400, n_cr).astype(np.int64),
        "cr_item_sk": cs["cs_item_sk"][pick],
        "cr_refunded_customer_sk": cs["cs_bill_customer_sk"][pick],
        "cr_refunded_cdemo_sk": cs["cs_bill_cdemo_sk"][pick],
        "cr_refunded_hdemo_sk": cs["cs_bill_hdemo_sk"][pick],
        "cr_refunded_addr_sk": cs["cs_bill_addr_sk"][pick],
        "cr_returning_customer_sk": cs["cs_bill_customer_sk"][pick],
        "cr_returning_cdemo_sk": cs["cs_bill_cdemo_sk"][pick],
        "cr_returning_hdemo_sk": cs["cs_bill_hdemo_sk"][pick],
        "cr_returning_addr_sk": cs["cs_bill_addr_sk"][pick],
        "cr_call_center_sk": cs["cs_call_center_sk"][pick],
        "cr_catalog_page_sk": cs["cs_catalog_page_sk"][pick],
        "cr_ship_mode_sk": cs["cs_ship_mode_sk"][pick],
        "cr_warehouse_sk": cs["cs_warehouse_sk"][pick],
        "cr_reason_sk": keys(n_cr, n_reason),
        "cr_order_number": cs["cs_order_number"][pick],
        "cr_return_quantity": ret["quantity"],
        "cr_return_amount": ret["amt"],
        "cr_return_tax": ret["tax"],
        "cr_return_amt_inc_tax": ret["inc_tax"],
        "cr_fee": ret["fee"],
        "cr_return_ship_cost": ret["ship_cost"],
        "cr_refunded_cash": ret["cash"],
        "cr_reversed_charge": ret["charge"],
        "cr_store_credit": ret["credit"],
        "cr_net_loss": ret["net_loss"],
    }
    n_wr = rows["web_returns"]
    pick = np.sort(rng.permutation(len(ws_qty))[:n_wr])
    ret = _returns(rng, ws_p["sales_price"][pick], ws_qty[pick])
    wr_date = ws["ws_ship_date_sk"][pick] + rng.integers(
        _RETURN_LAG[0], _RETURN_LAG[1] + 1, n_wr)
    tables["web_returns"] = {
        "wr_returned_date_sk": wr_date.astype(np.int64),
        "wr_returned_time_sk": rng.integers(0, 86400, n_wr).astype(np.int64),
        "wr_item_sk": ws["ws_item_sk"][pick],
        "wr_refunded_customer_sk": ws["ws_bill_customer_sk"][pick],
        "wr_refunded_cdemo_sk": ws["ws_bill_cdemo_sk"][pick],
        "wr_refunded_hdemo_sk": ws["ws_bill_hdemo_sk"][pick],
        "wr_refunded_addr_sk": ws["ws_bill_addr_sk"][pick],
        "wr_returning_customer_sk": ws["ws_bill_customer_sk"][pick],
        "wr_returning_cdemo_sk": ws["ws_bill_cdemo_sk"][pick],
        "wr_returning_hdemo_sk": ws["ws_bill_hdemo_sk"][pick],
        "wr_returning_addr_sk": ws["ws_bill_addr_sk"][pick],
        "wr_web_page_sk": ws["ws_web_page_sk"][pick],
        "wr_reason_sk": keys(n_wr, n_reason),
        "wr_order_number": ws["ws_order_number"][pick],
        "wr_return_quantity": ret["quantity"],
        "wr_return_amt": ret["amt"],
        "wr_return_tax": ret["tax"],
        "wr_return_amt_inc_tax": ret["inc_tax"],
        "wr_fee": ret["fee"],
        "wr_return_ship_cost": ret["ship_cost"],
        "wr_refunded_cash": ret["cash"],
        "wr_reversed_charge": ret["charge"],
        "wr_account_credit": ret["credit"],
        "wr_net_loss": ret["net_loss"],
    }

    # -- inventory: each week, every current item in every warehouse ---------
    weeks = sales_lo + 7 * np.arange(_INVENTORY_WEEKS, dtype=np.int64)
    current = np.nonzero(rev == nrev - 1)[0] + 1
    n_inv = rows["inventory"]
    per_week = len(current) * n_wh
    tables["inventory"] = {
        "inv_date_sk": np.repeat(weeks, per_week),
        "inv_item_sk": np.tile(np.repeat(current.astype(np.int64), n_wh),
                               _INVENTORY_WEEKS),
        "inv_warehouse_sk": np.tile(np.arange(1, n_wh + 1, dtype=np.int64),
                                    _INVENTORY_WEEKS * len(current)),
        "inv_quantity_on_hand": pa.array(
            rng.integers(0, 1001, n_inv).astype(np.int64),
            mask=rng.random(n_inv) < 0.05),
    }

    paths: Dict[str, str] = {}
    for name in TABLES:
        path = os.path.join(out_dir, name)
        paths[name] = path
        if os.path.isdir(path) and os.listdir(path):
            continue  # already generated (deterministic)
        os.makedirs(path, exist_ok=True)
        pq.write_table(pa.table(tables[name]),
                       os.path.join(path, "part-0.parquet"))
    return paths

